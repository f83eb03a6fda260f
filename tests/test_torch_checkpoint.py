"""Checkpoint format shared by the two packages, the port's config copy, its
import boundary and its device default."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import backbone as jbb
from neutts_tpu.models import checkpoint as jckpt
from neutts_tpu.models import codec as jcd
from neutts_tpu_torch import config as tcfg
from neutts_tpu_torch.models import checkpoint as tckpt

import _torch_threads  # noqa: F401  (pins torch's threads in this process)

ROOT = Path(__file__).resolve().parent.parent


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_tree_equal(torch_tree, jax_tree):
    t = dict(_leaves(torch_tree))
    j = dict(_leaves(jax_tree))
    assert t.keys() == j.keys()
    for k, jv in j.items():
        tv = t[k]
        if isinstance(jv, (int, float)):
            assert tv == jv, k
            continue
        jv = np.asarray(jv)
        if jv.dtype.name == "bfloat16":
            assert tv.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                          jv.view(np.uint16).view(np.int16), err_msg=k)
        else:
            assert str(tv.dtype).replace("torch.", "") == jv.dtype.name, k
            np.testing.assert_array_equal(tv.numpy(), jv, err_msg=k)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = jcfg.TINY.scaled(dtype="bfloat16")
    p = jbb.init_params(cfg, jax.random.PRNGKey(3))  # bf16 leaves -> ".bf16" tags
    return cfg, jbb.quantize_params(p)  # + {"q","s"} dicts and the fused wqkv


def test_pipeline_checkpoint_loads_tensor_equal(tmp_path, jax_tree):
    cfg, bp = jax_tree
    cp = jcd.init_params(jcfg.CODEC_TINY, jax.random.PRNGKey(4))
    jckpt.save_pipeline(tmp_path, cfg, bp, jcfg.CODEC_TINY, cp)
    bcfg, tbp, ccfg, tcp = tckpt.load_pipeline(tmp_path, device="cpu")
    assert dataclasses.asdict(bcfg) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(ccfg) == dataclasses.asdict(jcfg.CODEC_TINY)
    _assert_tree_equal(tbp, jax.tree_util.tree_map(np.asarray, bp))
    _assert_tree_equal(tcp, jax.tree_util.tree_map(np.asarray, cp))


def test_params_from_numpy_tensor_equal(jax_tree):
    _, bp = jax_tree
    np_tree = jax.tree_util.tree_map(np.asarray, bp)
    _assert_tree_equal(tckpt.params_from_numpy(np_tree, "cpu"), np_tree)


def test_port_checkpoint_loads_in_jax(tmp_path, jax_tree):
    """The port writes the same format back (bf16 bits included)."""
    _, bp = jax_tree
    tree = tckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, bp), "cpu")
    tckpt.save_params(tmp_path / "b.npz", tree)
    back = jckpt.load_params(tmp_path / "b.npz")
    _assert_tree_equal(tree, jax.tree_util.tree_map(np.asarray, back))


def test_config_copy_matches_jax():
    for name in ("AIR", "NANO", "TINY", "CODEC", "CODEC_TINY", "STREAMING", "DEFAULT_LAYOUT"):
        assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name))
    assert tcfg.SPECIAL_TOKEN_NAMES == jcfg.SPECIAL_TOKEN_NAMES
    assert set(tcfg.BY_NAME) == set(jcfg.BY_NAME)
    assert tcfg.KV_AUTO_CROSSOVER == jcfg.KV_AUTO_CROSSOVER
    s = tcfg.SamplingConfig().constrained_to(tcfg.AIR.layout)
    assert s.speech_range == jcfg.SamplingConfig().constrained_to(jcfg.AIR.layout).speech_range
    assert tcfg.resolve_kv_dtype(tcfg.AIR.scaled(kv_dtype="auto"), 100).kv_dtype == "int4"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """Static scan (jax may already be imported by the interpreter's start-up
    hook, so sys.modules cannot tell): no module of the port, and not
    chip_smoke.py, imports jax or neutts_tpu, nor, at any level, a package
    the GPU machine lacks for the converters (safetensors, ml_dtypes, onnx,
    gguf), nor a module of the tests. transformers is imported only by the
    tokenizer's lazy fallback and the real-artifact runner."""
    files = sorted((ROOT / "neutts_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for sub in ("train/trainer.py", "train/data.py", "train/codec_trainer.py",
                "parallel/mesh.py", "parallel/distributed.py", "serving/multichip.py",
                "utils.py", "models/convert.py", "models/convert_codec.py",
                "models/convert_cli.py", "tools/verify_real_artifacts.py",
                "examples/_common.py", "examples/finetune.py"):
        assert f"neutts_tpu_torch/{sub}" in names, sub
    test_modules = {p.stem for p in (ROOT / "tests").glob("*.py")} | {"tests"}
    assert "synthetic_ckpt" in test_modules
    transformers_ok = {"neutts_tpu_torch/text/tokenizer.py",
                       "neutts_tpu_torch/tools/verify_real_artifacts.py"}
    bad = []
    for f in files:
        rel = f.relative_to(ROOT).as_posix()
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "neutts_tpu", "ml_dtypes", "safetensors", "onnx",
                       "gguf") or top in test_modules or (
                           top == "transformers" and rel not in transformers_ok):
                bad.append(f"{rel}: {mod}")
    assert not bad, bad


def _imported_names(path: Path, package: str):
    """Every module or name an import of `path` (a module of `package`)
    reaches, at any level, functions included, relative imports resolved:
    `from a import b` gives both `a` and `a.b`."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            base = parts[:len(parts) + 1 - node.level] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


def test_runtime_imports_point_one_way():
    """The stream's decode loop and the CUDA-graph mechanism depend on
    neither the serving core (`runtime.batching`) nor the layers above it
    (`serving`, `pipeline`): `batching` builds on `decode` and `graph`,
    `decode` on `graph`."""
    runtime = ROOT / "neutts_tpu_torch" / "runtime"
    above = ("neutts_tpu_torch.runtime.batching", "neutts_tpu_torch.serving",
             "neutts_tpu_torch.pipeline")
    bad = []
    for name in ("decode", "graph"):
        for mod in _imported_names(runtime / f"{name}.py", "neutts_tpu_torch.runtime"):
            if any(mod == a or mod.startswith(a + ".") for a in above):
                bad.append(f"{name}.py: {mod}")
    assert not bad, bad
    uses = set(_imported_names(runtime / "batching.py", "neutts_tpu_torch.runtime"))
    assert {"neutts_tpu_torch.runtime.graph", "neutts_tpu_torch.runtime.decode"} <= uses


def test_default_device_is_cuda():
    """Without a GPU the default device raises; only device='cpu' runs on the
    CPU (no silent fallback)."""
    from neutts_tpu_torch import NeuTTS

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NeuTTS.initialize_random()
    with pytest.raises(RuntimeError):
        NeuTTS.from_checkpoint(ROOT / "no-such-checkpoint")
    tts = NeuTTS.initialize_random(device="cpu", watermarker=None)
    assert tts.device.type == "cpu"
    assert tts.backbone_params["embed"].device.type == "cpu"
