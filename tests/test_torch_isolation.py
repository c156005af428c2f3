"""tpurec_torch stands alone: no module of it (nor chip_smoke.py, nor
scripts/serve_load.py) imports JAX, the JAX package or scikit-learn (the
port depends on none), its entry points refuse to fall back to the CPU
when no card is there, and its kernel build is keyed by source."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpurec", "sklearn")


def _port_files():
    return (sorted((REPO / "tpurec_torch").rglob("*.py"))
            + [REPO / "chip_smoke.py", REPO / "scripts" / "serve_load.py"])


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_port_file_imports_jax_or_tpurec():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        for name in _imported(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_port_entry_points_import_nothing_of_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / "tpurec_torch").rglob("*.py"))
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "assert 'tpurec_torch.serve' in sys.modules\n"
            "assert 'tpurec_torch.train.hybrid' in sys.modules\n"
            "assert 'tpurec_torch.train.loop' in sys.modules\n"
            "assert 'tpurec_torch.metrics' in sys.modules\n"
            "assert 'tpurec_torch.data.loader' in sys.modules\n"
            "assert 'tpurec_torch.cdc' in sys.modules\n"
            "assert 'tpurec_torch.cdc.engine' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})


def test_cli_imports_no_pandas_and_no_jax():
    """The CLI, with the data and utils packages, loads without pandas: the
    CSV datasets' branch imports it when it runs."""
    code = ("import sys\n"
            "import tpurec_torch.cli, tpurec_torch.data, tpurec_torch.utils\n"
            "import tpurec_torch.utils.profiling, tpurec_torch.data.fastcsv\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('pandas',)!r}]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})


def _imports_at(path: Path):
    """(module, whether the import sits inside a function) for each
    import statement of ``path``."""
    tree = ast.parse(path.read_text(), str(path))
    inner = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            yield name.split(".")[0], id(node) in inner


def test_pandas_only_where_tpurec_imports_it():
    """pandas: at the top of data/preprocess.py, and inside functions of
    data/fastcsv.py (the fallback) and cli.py (the CSV datasets' branch);
    nowhere else in the port, chip_smoke.py included."""
    where = {}
    for path in _port_files():
        for name, inner in _imports_at(path):
            if name == "pandas":
                where.setdefault(path.relative_to(REPO).as_posix(),
                                 set()).add(inner)
    assert where == {"tpurec_torch/data/preprocess.py": {False},
                     "tpurec_torch/data/fastcsv.py": {True},
                     "tpurec_torch/cli.py": {True}}
    pre = REPO / "tpurec_torch" / "data" / "preprocess.py"
    assert not {n for n, _ in _imports_at(pre)} & set(FORBIDDEN)


def _cfg():
    from tpurec_torch.config import Config, ModelConfig

    return Config(model=ModelConfig(model="mmoe", embed_dim=4,
                                    mmoe_expert_dims=(8,),
                                    mmoe_tower_dims=(4,), atten_embed_dim=4,
                                    att_layer_num=1))


def test_entry_points_refuse_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from tpurec_torch.serve import Predictor, predictor_from_checkpoint

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(_cfg(), (5, 7, 3), 3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(_cfg(), (5, 7, 3), 3, 2, device="cuda")
    import pickle

    from tpurec_torch.config import config_to_dict

    path = tmp_path / "c.pkl"
    with open(path, "wb") as f:
        pickle.dump({"config": config_to_dict(_cfg()),
                     "field_dims": [5, 7, 3], "n_domain": 3,
                     "domain_idx": 2}, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predictor_from_checkpoint(str(path))
    Predictor(_cfg(), (5, 7, 3), 3, 2, device="cpu")   # explicit CPU runs
    from tpurec_torch.train import Trainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_cfg(), (5, 7, 3), 3, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_cfg(), (5, 7, 3), 3, 2, device="cuda")
    Trainer(_cfg(), (5, 7, 3), 3, 2, device="cpu")     # explicit CPU runs
    from tpurec_torch.cli import main

    argv = ["--n_rows", "300", "--epoch", "1", "--save_path", ""]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--device", "cuda"])


def test_bf16_compute_is_refused():
    """bf16 compute is ported: a Predictor takes it (and serves in it);
    a compute dtype that names nothing still raises ValueError."""
    import dataclasses

    from tpurec_torch.serve import Predictor

    cfg = _cfg()
    for dtype in ("bfloat16", "bf16"):
        bf = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, compute_dtype=dtype))
        assert Predictor(bf, (5, 7, 3), 3, 2,
                         device="cpu").compute_dtype == dtype
    bad = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="float16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        Predictor(bad, (5, 7, 3), 3, 2, device="cpu")


def test_build_is_keyed_by_source(tmp_path, monkeypatch):
    from tpurec_torch.ops import _build

    assert set(_build.sources()) == {"cross_network", "embedding_gather",
                                     "field_attention", "fused_adam"}
    a, b = tmp_path / "k.cu", tmp_path / "k2.cu"
    a.write_text("// one\n")
    b.write_text("// two\n")
    assert _build._lib_path(a) != _build._lib_path(b)
    assert _build._lib_path(a).parent == _build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.nvcc()
    with pytest.raises(_build.KernelCompileError, match="no source"):
        _build.build(["nope"])
