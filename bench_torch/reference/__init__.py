"""Plain PyTorch references the port is held to: the softened direct sum
and energies (``direct.py``), the Milky Way field (``milky_way.py``) and the
cluster centre's orbit (``orbit.py``). Nothing here imports the program.
"""
