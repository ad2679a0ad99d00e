"""Every committed config parses to the same tree in the port and in the
JAX package (the port's config.py is a copy that must not drift)."""
import glob
import os

import pytest

from oc_nbody_tpu import config as jconfig
from oc_nbody_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.toml")))


def test_all_configs_are_covered():
    assert len(CONFIGS) == 24


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_parses_identically(path):
    overrides = ["integrator.eps=0.01", "output.fractions=[0.5]"]
    ours = tconfig.apply_overrides(tconfig.load_config(path), overrides)
    theirs = jconfig.apply_overrides(jconfig.load_config(path), overrides)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.to_json() == theirs.to_json()
