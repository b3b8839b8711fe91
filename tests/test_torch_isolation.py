"""The port stands alone: no module of ``na_dd_tpu_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package (checked on the
AST of every file), the CUDA sources include only their own headers and the
CUDA toolkit's, every source has its ``ctypes`` declarations, and the entry
points never fall back to the CPU on their own — without a card and without
an explicit device they raise."""

import ast
import pathlib
import re

import pytest
import torch

from na_dd_tpu_torch import config
from na_dd_tpu_torch.convert import grid3_from_nodes, grid_from_nodes, state_from_numpy, tensor_from_numpy
from na_dd_tpu_torch.harness import studies
from na_dd_tpu_torch.harness.batched_ladder import run_spatial_ladder_batched
from na_dd_tpu_torch.harness.checkpoint import load_state, load_state_sharded
from na_dd_tpu_torch.harness.ensemble import simulate_ensemble
from na_dd_tpu_torch.harness.legacy import run_convergence_studies
from na_dd_tpu_torch.mms.cases import MMSCasePol
from na_dd_tpu_torch.models.coefficients import Model02
from na_dd_tpu_torch.models.consts import STUDY_MODEL_CONSTS
from na_dd_tpu_torch.ops import kernels
from na_dd_tpu_torch.ops.grid import make_grid, make_uniform_grid
from na_dd_tpu_torch.parallel import dryrun_multichip, run_ranks
from na_dd_tpu_torch.studies import (
    ensemble_throughput,
    eta_gradient_study,
    run_all,
    run_study,
    three_d_study,
)
from na_dd_tpu_torch.three_d.batched_ladder import run_spatial_ladder3_batched
from na_dd_tpu_torch.three_d.diffusion import heat_mms_error
from na_dd_tpu_torch.three_d.grid import make_grid3, make_uniform_grid3
from na_dd_tpu_torch.three_d.harness import make_setup3, mms_error3
from na_dd_tpu_torch.three_d.mms import MMSCaseCsZeroCrossing3, MMSCaseExpSin3, MMSCasePol3

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "na_dd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "na_dd_tpu", "studies")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_port_files_were_found():
    assert len(PORT_FILES) >= 20
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "na_dd_tpu_torch/three_d/harness.py" in names
    assert "na_dd_tpu_torch/harness/studies.py" in names
    for module in ("simulate", "checkpoint", "gradients", "legacy"):
        assert f"na_dd_tpu_torch/harness/{module}.py" in names
    assert "na_dd_tpu_torch/ops/direct_solve.py" in names
    assert "na_dd_tpu_torch/three_d/direct_solve.py" in names
    assert "na_dd_tpu_torch/ops/adjoint.py" in names
    for module in ("harness/batched_ladder", "three_d/batched_ladder"):
        assert f"na_dd_tpu_torch/{module}.py" in names
    for module in ("studies/__init__", "studies/reference_values", "studies/run_study",
                   "studies/run_all", "studies/write_reproduction", "harness/plotting",
                   "utils/__init__", "utils/testing", "utils/timing",
                   "studies/three_d_study", "studies/eta_gradient_study",
                   "studies/ensemble_throughput", "studies/make_notebook"):
        assert f"na_dd_tpu_torch/{module}.py" in names
        if module.startswith("studies/"):
            # each entry point is among the files held to no module-level matplotlib
            assert REPO / f"na_dd_tpu_torch/{module}.py" in ENTRY_POINT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    for module in _imported_modules(path):
        root = module.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {module}"


#: what runs on the card's machine, which may lack matplotlib: the entry points
#: and the smoke script import it nowhere at module level
ENTRY_POINT_FILES = sorted((REPO / "na_dd_tpu_torch" / "studies").glob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", ENTRY_POINT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_entry_points_import_no_matplotlib_at_module_level(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] != "matplotlib", f"{path.name} imports {name}"
            assert name != "na_dd_tpu_torch.harness.plotting", f"{path.name} imports {name}"


def test_the_entry_points_load_without_matplotlib():
    """Importing every entry-point module pulls in neither matplotlib, the
    plotting module, JAX nor the JAX package's study scripts (checked in a fresh
    interpreter)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import na_dd_tpu_torch.studies.run_all, na_dd_tpu_torch.studies.run_study\n"
            "import na_dd_tpu_torch.studies.write_reproduction, na_dd_tpu_torch.utils\n"
            "import na_dd_tpu_torch.studies.three_d_study, na_dd_tpu_torch.studies.eta_gradient_study\n"
            "import na_dd_tpu_torch.studies.ensemble_throughput, na_dd_tpu_torch.studies.make_notebook\n"
            "bad = [m for m in sys.modules if m == 'na_dd_tpu_torch.harness.plotting'\n"
            "       or m.split('.')[0] in ('matplotlib', 'jax', 'na_dd_tpu', 'studies')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_orbax_import(path):
    """orbax imports JAX: the port's sharded checkpoints are its own."""
    for module in _imported_modules(path):
        assert module.split(".")[0] != "orbax", f"{path.name} imports {module}"


CSRC = REPO / "na_dd_tpu_torch" / "csrc"
TOOLKIT_HEADERS = {"cuda_runtime.h", "cooperative_groups.h"}
CUDA_SOURCES = ["stencil5.cu", "bicgstab.cu", "stencil7.cu", "bicgstab3.cu", "triple_solve.cu",
                "stencil5.cuh", "stencil7.cuh", "bicgstab.cuh"]


def test_every_cuda_source_is_listed():
    assert sorted(p.name for p in CSRC.iterdir()) == sorted(CUDA_SOURCES)
    assert sorted(kernels.SOURCES.values()) == sorted(n for n in CUDA_SOURCES if n.endswith(".cu"))


@pytest.mark.parametrize("name", CUDA_SOURCES)
def test_cuda_source_includes_only_its_own_and_toolkit_headers(name):
    """No PyTorch, JAX or third-party header: each source builds with nvcc
    alone into a plain-C library."""
    text = (CSRC / name).read_text()
    for header in re.findall(r'#include\s+"([^"]+)"', text):
        assert (CSRC / header).is_file(), f"{name} includes a missing header {header}"
    for header in re.findall(r"#include\s+<([^>]+)>", text):
        assert header in TOOLKIT_HEADERS, f"{name} includes <{header}>"
    if name.endswith(".cu"):
        assert 'extern "C"' in text and "error_string" in text


JAX_PACKAGE = REPO / "na_dd_tpu"
#: names of the JAX package's ``__all__`` that the port leaves out on
#: purpose: the x64 set-up (torch needs none)
NOT_PORTED = {"setup_x64"}
NOT_PORTED_PACKAGES = set()


def _jax_exports():
    """(port package, name) for every name of every ``__all__`` of the JAX
    package's ``__init__.py`` files, read from their AST (no import)."""
    for init in sorted(JAX_PACKAGE.rglob("__init__.py")):
        sub = init.parent.relative_to(JAX_PACKAGE).parts
        if sub and sub[0] in NOT_PORTED_PACKAGES:
            continue
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets
            ):
                for name in ast.literal_eval(node.value):
                    yield ".".join(("na_dd_tpu_torch", *sub)), name


JAX_EXPORTS = list(_jax_exports())


def test_jax_exports_were_found():
    packages = {pkg for pkg, _ in JAX_EXPORTS}
    assert {"na_dd_tpu_torch.ops", "na_dd_tpu_torch.models", "na_dd_tpu_torch.integrators",
            "na_dd_tpu_torch.three_d", "na_dd_tpu_torch.parallel", "na_dd_tpu_torch.utils"} <= packages
    assert len(JAX_EXPORTS) >= 100


@pytest.mark.parametrize("package", sorted({pkg for pkg, _ in JAX_EXPORTS}))
def test_every_jax_export_resolves_on_the_port(package):
    """Every name the JAX subpackage exports resolves on the port's twin
    package (eagerly or through its lazy ``__getattr__``), but for the
    listed non-ports."""
    import importlib

    module = importlib.import_module(package)
    missing = [name for pkg, name in JAX_EXPORTS
               if pkg == package and name not in NOT_PORTED and not hasattr(module, name)]
    assert not missing, f"{package} lacks {missing}"


def test_max_batch_is_the_kernels():
    """The wrappers' batch limit is the one the CUDA sources compile in."""
    found = re.search(r"constexpr int kMaxBatch = (\d+);", (CSRC / "bicgstab.cuh").read_text())
    assert found and int(found.group(1)) == kernels.MAX_BATCH


class _AnyLibrary:
    """Stands in for a ctypes library: any symbol can be declared on it."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_every_kernel_library_has_its_declarations(name):
    lib = _AnyLibrary()
    kernels._declare(name, lib)
    declared = [k for k, v in vars(lib).items() if hasattr(v, "argtypes")]
    assert declared, f"no argtypes declared for {name}"


def test_unknown_kernel_library_is_refused():
    with pytest.raises(ValueError, match="no declarations"):
        kernels._declare("stencil9", _AnyLibrary())


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "entry",
    [
        lambda: config.resolve_device(None),
        lambda: make_uniform_grid(4, 4),
        lambda: make_grid([0.0, 0.5, 1.0], [0.0, 0.5, 1.0]),
        lambda: grid_from_nodes([0.0, 0.5, 1.0], [0.0, 0.5, 1.0]),
        lambda: tensor_from_numpy([1.0, 2.0]),
        lambda: state_from_numpy([[[0.0]]] * 5),
        lambda: make_uniform_grid3(2, 2, 2),
        lambda: make_grid3([0.0, 0.5, 1.0], [0.0, 0.5, 1.0], [0.0, 0.5, 1.0]),
        lambda: grid3_from_nodes([0.0, 0.5, 1.0], [0.0, 0.5, 1.0], [0.0, 0.5, 1.0]),
        lambda: make_setup3(MMSCaseExpSin3, N=2, model=Model02(STUDY_MODEL_CONSTS)),
        lambda: mms_error3(MMSCaseExpSin3, N=2, model=Model02(STUDY_MODEL_CONSTS), Tf=0.01, dt=0.01),
        lambda: make_setup3(MMSCaseCsZeroCrossing3, N=2, model=Model02(STUDY_MODEL_CONSTS), variant="hcs"),
        lambda: mms_error3(MMSCasePol3, N=2, model=Model02(STUDY_MODEL_CONSTS), Tf=0.01, dt=0.01,
                           variant="cs"),
        lambda: mms_error3(MMSCaseExpSin3, N=2, model=Model02(STUDY_MODEL_CONSTS), Tf=0.01, dt=0.01,
                           integrator_params=dict(precision="mixed")),
        lambda: studies._make_trial(MMSCasePol, 4, 50.0, precision="mixed"),
        lambda: studies.run_spatial_study("pol", levels=1, verbose=False),
        lambda: studies.run_temporal_study("pol", levels=1, verbose=False),
        lambda: studies.run_eta_study("pol", N=4, etas=[50.0], verbose=False),
        lambda: run_convergence_studies(
            [(None, None, None, None, "x")],
            {"Tf": 0.01, "model": None, "N_base_spatial": 2, "num_spatial_refinements": 1,
             "dt_fixed_spatial": 0.01}),
        lambda: load_state("never-read"),
        lambda: heat_mms_error(4),
        lambda: run_spatial_ladder_batched("pol", levels=1, precision="mixed", verbose=False),
        lambda: run_spatial_ladder3_batched(MMSCaseExpSin3, model=Model02(STUDY_MODEL_CONSTS),
                                            levels=1, precision="mixed", verbose=False),
        lambda: simulate_ensemble([50.0], N=4, Tf=0.01, dt=0.01),
        lambda: run_ranks(print, 2, backend="gloo"),
        lambda: dryrun_multichip(2, backend="gloo"),
        lambda: load_state_sharded("never-read"),
        lambda: run_study.main(["--study", "pol", "--levels", "1"]),
        lambda: run_all.main(["--only", "pol", "eta"]),
        lambda: three_d_study.main(["--levels", "1"]),
        lambda: three_d_study.main(["--eta-sweep"]),
        lambda: eta_gradient_study.main(["--n", "4"]),
        lambda: eta_gradient_study.run([50.0], N=4),
        lambda: ensemble_throughput.main(["--batches", "1", "--n", "4"]),
        lambda: ensemble_throughput.main(["--batches", "2", "--n", "4", "--dp", "2"]),
    ],
)
def test_entry_points_without_a_card_raise(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_explicit_cpu_device_runs_in_float64_by_default(no_card):
    g = make_uniform_grid(4, 4, device="cpu")
    assert g.device.type == "cpu" and g.dtype == torch.float64


def test_dtype_is_checked():
    with pytest.raises(ValueError, match="float64 or torch.float32"):
        config.resolve_dtype(torch.float16)
