"""gymgo_tpu_torch stands alone: it imports neither JAX nor gymgo_tpu, and its
entry points run on CUDA unless told otherwise."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gymgo_tpu_torch
from gymgo_tpu_torch.config import EnvConfig
from gymgo_tpu_torch.core import state as tstate
from gymgo_tpu_torch.env.batch_env import BatchGoEnv

_REPO = Path(__file__).resolve().parent.parent

_CHECK = """
import importlib, pkgutil, sys
import gymgo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gymgo_tpu_torch.__path__, "gymgo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gymgo_tpu"))
import torch
assert not torch.cuda.is_initialized()  # importing the port touches no device
print(len(names), bad)
"""


def test_port_imports_no_jax_and_nothing_of_gymgo_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=_REPO, capture_output=True, text=True, check=True,
    ).stdout.split(maxsplit=1)
    n_modules, bad = int(out[0]), out[1].strip()
    assert n_modules >= 57, n_modules
    assert bad == "[]", bad


def test_every_module_is_found():
    names = {m.name for m in pkgutil.walk_packages(gymgo_tpu_torch.__path__, "gymgo_tpu_torch.")}
    for name in ("core.flood", "core.step", "core.actions", "core.score", "core.state",
                 "ops.bundle_flood", "ops.minmax_flood", "ops.cuda_lib", "env.batch_env",
                 "convert", "govars", "config", "core.transform", "models", "models.az_net", "rl",
                 "rl.treewalk", "rl.gumbel_mcts", "rl.search", "rl.evaluate", "rl.mcts", "rl.selfplay",
                 "rl.replay", "rl.learner", "models.surgery", "utils", "utils.checkpoint", "utils.profiling",
                 "train", "params_to_ckpt", "gogame", "native", "env.go_env", "env.go_extrahard_env",
                 "utils.metrics", "utils.render", "benchmarks", "benchmarks.mcts_bench", "core.debug",
                 "utils.faulttol", "utils.gui_math", "utils.sgf", "utils.gui", "utils.gtp", "scripts",
                 "scripts.gtp_match", "scripts.elo_ladder", "scripts.eval_ckpt", "scripts.export_params",
                 "scripts.net2net", "scripts.value_probe", "demo", "benchmarks.efficiency",
                 "benchmarks.native_batch"):
        assert f"gymgo_tpu_torch.{name}" in names


def test_kernel_source_ships_with_the_package():
    from gymgo_tpu_torch.ops import bundle_flood, cuda_lib, minmax_flood

    assert bundle_flood.SOURCE.is_file()
    assert minmax_flood.SOURCE.is_file()
    # the header both include ships too, and counts as part of each source
    header = cuda_lib.CSRC / "board_components.cuh"
    assert header.is_file()
    for source in (bundle_flood.SOURCE, minmax_flood.SOURCE):
        assert header in cuda_lib.source_files(source)
    package_data = (_REPO / "pyproject.toml").read_text()
    assert "csrc/*.cu" in package_data and "csrc/*.cuh" in package_data
    assert "sm_90a" in " ".join(cuda_lib.NVCC_FLAGS)
    # each kernel keeps its own launch count
    assert bundle_flood.BUNDLE_FLOOD is not minmax_flood.MINMAX_FLOOD


def test_library_name_follows_the_source_and_its_headers(tmp_path):
    import shutil

    from gymgo_tpu_torch.ops import cuda_lib

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    lib = cuda_lib.CudaKernelLib(csrc / "bundle_flood.cu", "bundle_flood_launch", ())
    other = cuda_lib.CudaKernelLib(csrc / "minmax_flood.cu", "minmax_flood_launch", ())
    before, other_before = lib.library_path(), other.library_path()
    assert lib.library_path() == before  # the same content, the same name
    with open(csrc / "board_components.cuh", "a") as f:
        f.write("// edited\n")
    assert lib.library_path() != before and other.library_path() != other_before
    after = lib.library_path()
    with open(csrc / "bundle_flood.cu", "a") as f:
        f.write("// edited\n")
    assert lib.library_path() != after
    assert other.library_path() != other_before  # its header changed, its source did not


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card):
    cfg = EnvConfig(board_size=9, batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchGoEnv(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.batch_init_state(4, 9)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstate.resolve_device("cuda")
    assert BatchGoEnv(cfg, device="cpu").reset().device.type == "cpu"


def test_sub_packages_ship_with_the_package():
    import tomllib

    from setuptools import find_packages

    include = tomllib.loads((_REPO / "pyproject.toml").read_text())["tool"]["setuptools"]["packages"]["find"]["include"]
    found = set(find_packages(where=str(_REPO), include=include))
    assert {"gymgo_tpu_torch", "gymgo_tpu_torch.core", "gymgo_tpu_torch.ops", "gymgo_tpu_torch.env",
            "gymgo_tpu_torch.models", "gymgo_tpu_torch.rl", "gymgo_tpu_torch.utils", "gymgo_tpu_torch.native",
            "gymgo_tpu_torch.benchmarks", "gymgo_tpu_torch.scripts"} <= found
    package_data = tomllib.loads((_REPO / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"]
    assert "*.cc" in package_data["gymgo_tpu_torch.native"]
