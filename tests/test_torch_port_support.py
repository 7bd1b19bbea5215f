"""The port's support modules against the JAX package's: `utils/config.py`
(`load_config`, `get_model`, `defense_kwargs_from_config`) and
`utils/profiling.py` (`PhaseTimer`, `trace`), on the CPU.

Configs: every `configs/*.yaml`, with and without `default.yaml`, and an
`inherit_from` chain written here, load to the JAX package's dicts
(equal). `get_model` on the shipped ConvONet config and the reduced ONet
config builds port modules that strict-load `params_from_jax` of the JAX
`get_model`'s init (perturbed) and match its outputs within rtol 1e-4,
atol 1e-5 (the module tests' bound). The port's modules import without
PyYAML.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from if_defense_tpu.utils import config as jconfig
from if_defense_tpu.utils import profiling as jprofiling
from if_defense_tpu_torch.utils import config, profiling
from if_defense_tpu_torch.utils.params_io import params_from_jax
from test_torch_port_victims import perturbed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")
DEFAULT = os.path.join(CONFIGS, "default.yaml")
NAMES = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".yaml"))


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NAMES)
def test_load_config_matches_jax(name):
    path = os.path.join(CONFIGS, name)
    for default in (None, DEFAULT):
        got = config.load_config(path, default)
        assert got == jconfig.load_config(path, default)
        assert config.defense_kwargs_from_config(got) == \
            jconfig.defense_kwargs_from_config(got)


def test_inherit_chain(tmp_path):
    """A three-file `inherit_from` chain (relative and absolute parents):
    parent, then default, then the file's own values, merged recursively."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "base.yaml").write_text(
        "method: onet\nmodel:\n  c_dim: 64\n  encoder_kwargs:\n"
        "    hidden_dim: 64\ntest:\n  threshold: 0.3\n")
    (tmp_path / "sub" / "mid.yaml").write_text(
        f"inherit_from: {tmp_path / 'base.yaml'}\nmodel:\n  c_dim: 32\n")
    (tmp_path / "sub" / "leaf.yaml").write_text(
        "inherit_from: mid.yaml\nmodel:\n  decoder_kwargs:\n"
        "    hidden_size: 16\ndata:\n  pointcloud_n: 100\n")
    leaf = str(tmp_path / "sub" / "leaf.yaml")
    for default in (None, DEFAULT):
        got = config.load_config(leaf, default)
        assert got == jconfig.load_config(leaf, default)
    assert got["model"] == {"c_dim": 32, "encoder_kwargs": {
        "hidden_dim": 64, "plane_resolution": 64},
        "decoder_kwargs": {"hidden_size": 16}}
    assert got["method"] == "onet" and got["training"]["batch_size"] == 32
    assert config.defense_kwargs_from_config(got) == {"threshold": 0.3,
                                                      "input_npoint": 100}
    assert config.update_recursive({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) \
        == {"a": {"b": 3, "c": 2}}
    with pytest.raises(ValueError, match="unknown method"):
        config.get_model({"method": "nope"})


@pytest.mark.parametrize("name", ["convonet_3plane_mn40.yaml",
                                  "onet_mn40_small.yaml"])
def test_get_model_matches_jax(name):
    cfg = config.load_config(os.path.join(CONFIGS, name), DEFAULT)
    jm, pm = jconfig.get_model(cfg), config.get_model(cfg)
    rng = np.random.default_rng(7)
    pc = rng.uniform(-0.45, 0.45, (2, 64, 3)).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, (2, 32, 3)).astype(np.float32)
    variables = perturbed(jm.init(jax.random.key(0), jnp.asarray(pc),
                                  jnp.asarray(q)), 3)
    pm.load_state_dict(params_from_jax(variables, pm), strict=True)
    c = jm.apply(variables, jnp.asarray(pc), method="encode_inputs")
    want = jm.apply(variables, jnp.asarray(q), c, method="decode")
    with torch.no_grad():
        got = pm.eval().decode(torch.from_numpy(q),
                               pm.encode_inputs(torch.from_numpy(pc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_phase_timer_matches_jax():
    """The same phases give the same summary keys and counts, and each
    phase's total is the wall time it held (within the host's clock)."""
    timers = (profiling.PhaseTimer(), jprofiling.PhaseTimer())
    x = torch.ones(3)
    for timer in timers:
        for name, sync in (("a", None), ("b", x), ("a", x)):
            with timer.phase(name, sync if timer is timers[0]
                             else None if sync is None
                             else jnp.asarray(sync.numpy())):
                time.sleep(0.01)
    got, want = (t.summary() for t in timers)
    assert got.keys() == want.keys() == {"a", "b"}
    for name in got:
        assert got[name].keys() == want[name].keys()
        assert got[name]["count"] == want[name]["count"]
        assert got[name]["total_s"] >= 0.01 * got[name]["count"]
        assert got[name]["mean_s"] == pytest.approx(
            got[name]["total_s"] / got[name]["count"])
    profiling.PhaseTimer.sync(x)                 # nothing to wait for


def test_trace_writes_a_file(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as out:
        with torch.profiler.record_function("phase.mark"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = out["path"]
    assert os.path.dirname(path) == str(tmp_path / "trace")
    text = open(path).read()
    assert "phase.mark" in text and '"traceEvents"' in text


_NO_YAML = """
import sys
sys.modules["yaml"] = None
import if_defense_tpu_torch.utils
from if_defense_tpu_torch.utils import config
model = config.get_model({"method": "onet", "model": {"c_dim": 8,
                          "encoder_kwargs": {"hidden_dim": 8}}})
try:
    config.load_config("configs/onet_mn40.yaml")
except ImportError as e:
    assert "PyYAML" in str(e), e
    print("ok")
"""


def test_utils_import_without_yaml():
    out = subprocess.run([sys.executable, "-c", _NO_YAML], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
