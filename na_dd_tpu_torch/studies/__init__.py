"""studies (port of the repo's ``studies/`` scripts): the user entry points
of the port.

* :mod:`na_dd_tpu_torch.studies.run_study` — the study CLI
  (``python -m na_dd_tpu_torch.studies.run_study``), twin of
  ``studies/run_study.py``;
* :mod:`na_dd_tpu_torch.studies.run_all` — the six-notebook reproduction
  (``python -m na_dd_tpu_torch.studies.run_all``), twin of
  ``studies/run_all_tpu.py``, every over-gate level held to the JAX
  package's CPU-x64 record;
* :mod:`na_dd_tpu_torch.studies.write_reproduction` — its report;
* :mod:`na_dd_tpu_torch.studies.three_d_study` — the 3-D study
  (``python -m na_dd_tpu_torch.studies.three_d_study``), twin of
  ``studies/three_d_study.py``;
* :mod:`na_dd_tpu_torch.studies.eta_gradient_study` — dObs/dη through the
  adjoints, twin of ``studies/eta_gradient_study.py``;
* :mod:`na_dd_tpu_torch.studies.ensemble_throughput` — the ensemble screen's
  throughput, twin of ``studies/ensemble_throughput.py``;
* :mod:`na_dd_tpu_torch.studies.make_notebook` — the notebooks, twin of
  ``studies/make_notebook.py``;
* :mod:`na_dd_tpu_torch.studies.reference_values` — the notebooks' saved
  outputs and the CPU-x64 records.

The entry points write only to their own directories, ``studies/results_torch/``
and ``studies/notebooks_torch/`` at the repo root, or to the directory they
are given; never to ``studies/results/``, ``studies/notebooks/`` or the root
``REPRODUCTION.md``.
"""

import subprocess
from pathlib import Path

#: The port's results directory: ``studies/results_torch/`` at the repo root.
RESULTS_DIR = Path(__file__).resolve().parents[2] / "studies" / "results_torch"
#: The JAX study scripts' outputs, which the port's entry points never write.
_JAX_OUTPUTS = (
    Path(__file__).resolve().parents[2] / "studies" / "results",
    Path(__file__).resolve().parents[2] / "studies" / "notebooks",
    Path(__file__).resolve().parents[2] / "REPRODUCTION.md",
)


def checked_output(path) -> Path:
    """``path`` as an absolute Path; raises ``ValueError`` if it is, or lies
    inside, an output of the JAX study scripts."""
    path = Path(path).resolve()
    for jax_output in _JAX_OUTPUTS:
        if path == jax_output or jax_output in path.parents:
            raise ValueError(f"{path} belongs to the JAX study scripts; the port writes elsewhere")
    return path


def device_label(device) -> str:
    """The device a run used: on the card its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them, else the torch device."""
    if device.type != "cuda":
        return str(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(device)} (power limit not read)"
