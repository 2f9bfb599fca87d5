"""The port stands alone: importing every ``repro_torch`` module pulls in
none of ``jax``, ``ml_dtypes`` and ``repro`` (checked in a fresh interpreter, since this
test process already imports both); no source file of the port, nor
chip_smoke.py, imports them; the entry points default to the card and raise
without one; and a kernel wrapper never falls back to its plain version."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.core.taco" in mods and "repro_torch.kernels.cuda" in mods
    assert {"repro_torch.batching", "repro_torch.checkpoint.checkpoint",
            "repro_torch.ann.persistence", "repro_torch.ann.searcher",
            "repro_torch.kernels.flash_attention", "repro_torch.ann.mutable",
            "repro_torch.ann.wal", "repro_torch.ann.compaction", "repro_torch.obs",
            "repro_torch.obs.metrics", "repro_torch.obs.trace", "repro_torch.obs.export",
            "repro_torch.serving", "repro_torch.serving.scheduler",
            "repro_torch.serving.ann_engine", "repro_torch.serving.batching",
            "repro_torch.launch", "repro_torch.launch.serve_ann",
            "repro_torch.core.distributed", "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.attention", "repro_torch.models.taco_attention",
            "repro_torch.models.model", "repro_torch.models.convert",
            "repro_torch.models.moe", "repro_torch.models.ssm", "repro_torch.configs",
            "repro_torch.configs.registry", "repro_torch.configs.granite_3_2b",
            "repro_torch.serving.engine", "repro_torch.launch.serve",
            "repro_torch.data.io", "repro_torch.data.tokens", "repro_torch.core.ivf",
            "repro_torch.core.sclinear", "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.adafactor", "repro_torch.optim.clip",
            "repro_torch.optim.schedule", "repro_torch.train", "repro_torch.train.loop",
            "repro_torch.train.losses", "repro_torch.launch.train", "repro_torch.mesh",
            "repro_torch.optim.compression", "repro_torch.launch.mesh",
            "repro_torch.launch.elastic", "repro_torch.configs.shapes",
            "repro_torch.launch.op_analysis", "repro_torch.launch.dryrun_ann",
            "repro_torch.launch.dryrun", "repro_torch.launch.sharding",
            "repro_torch.models.sharding_utils", "repro_torch.models.sharded",
            "repro_torch.kernels.autotune"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), f"{path} imports {name}"


def test_kernel_sources_exist_for_every_kernel():
    from repro_torch.kernels import cuda

    for name in cuda.KERNELS:
        src = (PORT / "csrc" / f"{name}.cu").read_text()
        assert "Replaces:" in src and "Bound on the H100" in src and "Design" in src
        assert f"{name}_error_string" in src


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.ann import AnnIndex, MutableAnnIndex
    from repro_torch.core import taco
    from repro_torch.core.config import taco_config

    data = torch.zeros((64, 8))
    cfg = taco_config(n_subspaces=2, subspace_dim=2, n_clusters=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnnIndex.build(data, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableAnnIndex.build(data, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableAnnIndex(cfg=cfg, dim=8)  # a delta-only index
    # AnnIndex.mutable keeps the base where it lies: the card by default
    assert AnnIndex.build(data, cfg, device="cpu").mutable().device.type == "cpu"
    saved = MutableAnnIndex(cfg=cfg, dim=8, device="cpu").save(str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableAnnIndex.load(saved)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnnIndex.load(saved)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taco.build(data, taco_config(n_subspaces=2, subspace_dim=2, n_clusters=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taco.index_from_arrays({}, (2, 2))

    # the LM side: parameters, the engine and its launcher
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import init_params, params_from_arrays
    from repro_torch.serving import ServingEngine

    lm = get_smoke("granite-3-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator().manual_seed(0), lm)
    params = init_params(torch.Generator().manual_seed(0), lm, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_arrays(params, lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(params, lm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke", "--requests", "1", "--max-new", "1"])

    # the baselines and training
    from repro_torch.core import SCLinear, build_ivf
    from repro_torch.core.config import suco_config
    from repro_torch.core.ivf import ivf_index_from_arrays
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.train import train_state_init

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_ivf(data, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ivf_index_from_arrays(torch.zeros((4, 8)), torch.zeros((4, 2)), data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SCLinear(data, suco_config(n_subspaces=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_state_init(torch.Generator().manual_seed(0), lm, adamw()[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])


def test_kernel_wrappers_never_fall_back():
    from repro_torch.kernels import cuda, ops
    from repro_torch.kernels.l2dist import l2dist_cuda

    x = torch.zeros((4, 3))
    before = dict(cuda.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        l2dist_cuda(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        ops.l2dist(x, x, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmeans_assign(x, x, impl="kernel")
    with pytest.raises(ValueError):
        ops.l2dist(x, x, impl="pallas")
    assert ops.l2dist(x, x, impl="auto").shape == (4, 4)  # CPU tensor: plain version
    assert dict(cuda.launch_counts) == before
    cuda.reset_launch_counts()
    assert set(cuda.launch_counts.values()) == {0}
