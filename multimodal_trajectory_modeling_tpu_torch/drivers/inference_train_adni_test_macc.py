"""ADNI→MACC transfer experiment.

Counterpart of ``drivers/inference-train-adni-test-macc.py``.  The MACC
trajectories are not shipped (patient privacy), so this driver prints the
JAX driver's notice and exits with code 0; the experiment itself (the
cached 3-cluster ADNI fit applied to MACC under three input variants,
their prevalences, χ² tests, figures and the visit-wise MMSE table) waits
for the data and is not ported.

Usage::

    python -m multimodal_trajectory_modeling_tpu_torch.drivers.inference_train_adni_test_macc
"""

from __future__ import annotations

from multimodal_trajectory_modeling_tpu_torch.utils import macc as data_macc


def main() -> int:
    if not data_macc.data_available():
        print(
            "MACC trajectories are not shipped (patient privacy); "
            "skipping the ADNI→MACC transfer experiment."
        )
        return 0
    raise NotImplementedError(
        "the MACC data are present, but the ADNI→MACC transfer experiment is not ported; "
        "run drivers/inference-train-adni-test-macc.py"
    )


if __name__ == "__main__":
    raise SystemExit(main())
