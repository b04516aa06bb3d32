"""The port imports torch and never jax or scikit-learn (its k-means init
included), and refuses a CUDA device it does not have."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodal_trajectory_modeling_tpu_torch import resolve_device, resolve_dtype
from multimodal_trajectory_modeling_tpu_torch.models import em as tem
from multimodal_trajectory_modeling_tpu_torch.models import (
    MMLinGaussSS_marginalizable,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import multimodal_trajectory_modeling_tpu_torch\n"
        "import multimodal_trajectory_modeling_tpu_torch.models.em\n"
        "import multimodal_trajectory_modeling_tpu_torch.models.kmeans\n"
        "import multimodal_trajectory_modeling_tpu_torch.models.mixture\n"
        "import multimodal_trajectory_modeling_tpu_torch.ops.markov_kernels\n"
        "import multimodal_trajectory_modeling_tpu_torch.ops.regression\n"
        "import numpy as np\n"
        "from multimodal_trajectory_modeling_tpu_torch.models import "
        "MMLinGaussSS_marginalizable as M\n"
        "z = np.random.default_rng(0).normal(size=(3, 50, 2))\n"
        "M(2, z, z, init='kmeans', device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'multimodal_trajectory_modeling_tpu.', 'sklearn')) or m == "
        "'multimodal_trajectory_modeling_tpu')\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tem.mixture_params_from_numpy([np.ones(2)] * 7, device="cuda")
    z = np.zeros((3, 10, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MMLinGaussSS_marginalizable(2, z, z, device="cuda")


def test_default_device_is_the_card(tmp_path):
    """With no ``device=``, the constructor, ``from_pickle`` and
    ``em.mixture_params_from_numpy`` ask for the card; without one they
    raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    z = np.random.default_rng(0).normal(size=(3, 10, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MMLinGaussSS_marginalizable(2, z, z)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tem.mixture_params_from_numpy([np.ones(2)] * 7)
    MMLinGaussSS_marginalizable(2, z, z, device="cpu").to_pickle(save_location=str(tmp_path))
    (path,) = tmp_path.glob("mmm-*.p.gz")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MMLinGaussSS_marginalizable.from_pickle(path, training_data={"states": z, "observations": z})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()


def test_default_dtypes():
    assert resolve_dtype(torch.device("cpu")) == torch.float64
    assert resolve_dtype(torch.device("cuda")) == torch.float32
    assert resolve_dtype(torch.device("cpu"), torch.float32) == torch.float32
    with pytest.raises(ValueError):
        resolve_dtype(torch.device("cpu"), torch.float16)
