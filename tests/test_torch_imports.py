"""The port stands alone: no module of tee_optical_flow_torch, nor
epe_report_torch.py or the card suite's test files, imports JAX or the
JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tee_optical_flow_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tee_optical_flow_tpu",
             "optical_flow")
# the test files of the card suite (their ``cuda`` cases, run on the card's
# machine, which has no JAX, with ``--noconftest``) and the file they
# import from
CARD_SUITE = ("test_torch_cuda.py", "test_torch_attention.py",
              "test_torch_labelling.py", "test_torch_tracing.py",
              "test_torch_train_mesh.py", "test_torch_card_paths.py",
              "test_torch_norm_kernel.py")


def _modules():
    names = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_importing_the_port_loads_no_jax():
    """Every module of the port and epe_report_torch (its main does not
    run on import), in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r} + ['epe_report_torch']:\n"
        "    importlib.import_module(name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "epe_report_torch.py"] +
                         [ROOT / "tests" / name for name in CARD_SUITE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), (path, roots)


def test_port_imports_without_h5py_pandas_matplotlib():
    """The card's machine has none of the three: every module of the port
    imports with them blocked (each is imported inside the function that
    needs it)."""
    code = (
        "import importlib, sys\n"
        "for name in ('h5py', 'pandas', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_training_imports_without_pil_tensorboardx():
    """The trainer's modules import without PIL, tensorboardX and
    matplotlib: each is imported where it is used (train/data where a
    file is read; train/loop runs without a writer where tensorboardX is
    absent)."""
    code = (
        "import importlib, sys\n"
        "for name in ('PIL', 'tensorboardX', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "for name in ('tee_optical_flow_torch.train',\n"
        "             'tee_optical_flow_torch.train.data',\n"
        "             'tee_optical_flow_torch.train.visutils',\n"
        "             'tee_optical_flow_torch.cli.train',\n"
        "             'tee_optical_flow_torch.cli.val'):\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# the JAX package's public names that the port carries under another name
# (its _jnp-suffixed functions: the port's are torch functions) ...
RENAMED = {"ops": {"img2uint8_jnp": "img2uint8",
                   "savgol_filter_jnp": "savgol_filter_torch"}}
# ... that it does not carry yet (none: the mesh names came last)
NOT_PORTED = {}
# ... and the port's own public names beyond them
PORT_ONLY = {"flow": {"process_folder"},
             "io": {"read_dicom_clip", "extract_metadata",
                    "write_dicom_clip"},
             "models": {"build_sam_vit_l", "build_sam_vit_h",
                        "make_clip_segmentor", "preprocess_frames"},
             "signal": {"spectral_smooth_torch"},
             "viz": {"colormap_lut", "radlong_overlay_frames"}}


# modules of one package only: the JAX package's Pallas kernels (the port's
# CUDA kernels and their build and bindings stand in for them), the
# port's process-per-rank training (XLA inserts the JAX package's
# collectives; its mesh is single-controller) and the port's plain float32
# SAM that its ViT-Det segmentor is held to
JAX_ONLY_MODULES = {"ops.deepflow_pallas", "ops.pallas_common",
                    "ops.tvl1_pallas"}
PORT_ONLY_MODULES = {"ops.cuda_lib", "ops.deepflow_kernels",
                     "ops.tvl1_kernels", "ops.attention_kernels",
                     "ops.norm_kernels",
                     "parallel.collectives", "parallel.launch",
                     "train.mesh_steps", "models.vitdet_oracle"}


def _module_names(package):
    out = set()
    for path in (ROOT / package).rglob("*.py"):
        parts = list(path.relative_to(ROOT / package).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.add(".".join(parts))
    return out


def test_module_names_match_jax():
    """The port has every module of the JAX package, parallel/shardings
    included, but the Pallas ones, and no module of its own beyond
    PORT_ONLY_MODULES."""
    j = _module_names("tee_optical_flow_tpu")
    t = _module_names("tee_optical_flow_torch")
    assert j - t == JAX_ONLY_MODULES
    assert t - j == PORT_ONLY_MODULES
    assert "parallel.shardings" in t


def test_parallel_modules_load_no_jax():
    """parallel/launch, parallel/collectives and parallel/shardings (and
    the ranks' target, train/mesh_steps) in a fresh interpreter."""
    names = ["tee_optical_flow_torch.parallel." + n
             for n in ("launch", "collectives", "shardings")]
    names.append("tee_optical_flow_torch.train.mesh_steps")
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _public(module):
    """``__all__``, or for a module without one (exceptions) its public
    classes."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {n for n, v in vars(module).items()
            if isinstance(v, type) and not n.startswith("_")
            and v.__module__ == module.__name__}


@pytest.mark.parametrize("name", [
    "", "analysis", "batch", "cli", "exceptions", "flow", "io", "legacy",
    "models", "ops", "parallel", "signal", "train", "utils", "viz"])
def test_public_names_match_jax(name):
    """Each subpackage exports the JAX package's names (under the port's
    name where RENAMED says so), but for NOT_PORTED, and nothing else but
    PORT_ONLY; every exported name resolves."""
    import importlib

    suffix = "." + name if name else ""
    j = importlib.import_module("tee_optical_flow_tpu" + suffix)
    t = importlib.import_module("tee_optical_flow_torch" + suffix)
    renamed = RENAMED.get(name, {})
    want = {renamed.get(n, n) for n in _public(j)} - NOT_PORTED.get(name,
                                                                    set())
    assert _public(t) == want | PORT_ONLY.get(name, set())
    for n in _public(t):
        assert hasattr(t, n), n
