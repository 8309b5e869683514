"""The port's own configs against fr_tpu's, and the rule that the port
imports nothing of the JAX package: load_config of the port equals
fr_tpu's for every config module under several override sets (fr_tpu's
re-flatten that resets ms1m_arcface_122's sample_rate 0.3 to 1.0 included),
and an AST scan of every module of fr_tpu_torch/ and of chip_smoke.py finds
no import of fr_tpu, jax, flax, orbax or the root bench.py."""

import ast
from pathlib import Path

import pytest

from fr_tpu import configs as jax_configs
from fr_tpu_torch import configs

ROOT = Path(__file__).resolve().parent.parent
# the JAX package, JAX itself, and fr_tpu's bench.py at the repository root
FORBIDDEN = ("fr_tpu", "jax", "jaxlib", "flax", "orbax", "bench")
OVERRIDES = [
    {},
    {"network": "Swin50"},
    {"network": "EffiAlter_m", "loss": "ArcFace", "sample_rate": 0.3},
    {"optimizer": "AdamW", "lr": 0.01, "network": "ResNet100"},
    {"loss": "CosFace", "ckpt_path": "x.npz", "network": None},
]


@pytest.mark.parametrize("overrides", OVERRIDES,
                         ids=lambda o: ",".join(o) or "none")
@pytest.mark.parametrize("name", ["lfw", "ms1m_arcface_122", "webface42m"])
def test_load_config_equals_fr_tpu(name, overrides):
    ours = configs.load_config(name, **overrides)
    ref = jax_configs.load_config(name, **overrides)
    assert dict(ours) == dict(ref)
    assert type(ours).__module__ == "fr_tpu_torch.configs.base"


def test_the_reflatten_resets_sample_rate_as_fr_tpu_does():
    assert configs.load_config("ms1m_arcface_122").sample_rate == 1.0
    assert configs.load_config("ms1m_arcface_122",
                               sample_rate=0.3).sample_rate == 0.3


@pytest.mark.parametrize("network", ["AlterNet50", "AlterNetSep50", "Swin50",
                                     "EffiAlter_m", "ResNet100"])
def test_default_img_size_equals_fr_tpu(network):
    assert configs.default_img_size(network) == \
        jax_configs.default_img_size(network)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    return sorted((ROOT / "fr_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_nothing_of_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from fr_tpu.configs import base\n"
                     "    import jax.numpy as jnp\n    import bench\n"
                     "    from fr_tpu_torch import bench as ours\n")
    assert [m.split(".")[0] for m in _imports(probe)
            if m.split(".")[0] in FORBIDDEN] == ["fr_tpu", "jax", "bench"]
