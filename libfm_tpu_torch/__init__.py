"""libfm_tpu_torch: the PyTorch/CUDA port of libfm_tpu.

The same factorization machine learners as `libfm_tpu`, with the same
module layout and names, written in PyTorch for one NVIDIA H100. Plain
tensor code is PyTorch; the vector engine's and the SGD step's hot loops
are CUDA C++ kernels written by hand for sm_90a (`csrc/`, bound in
`kernels/`).

The port imports neither jax nor any module of `libfm_tpu`: it keeps its
own copies of the host-side data code.

Precision: the JAX engine pins full-f32 products wherever terms cancel
(the lane Cholesky, the relational caches), so TF32 is switched off for
matmuls and convolutions at import. Every kernel of the port computes in
fp32 FMA on the CUDA cores.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from libfm_tpu_torch.data.dataset import Dataset  # noqa: E402
from libfm_tpu_torch.device import resolve_device  # noqa: E402
from libfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner  # noqa: E402
from libfm_tpu_torch.learners.mcmc_vector import (  # noqa: E402
    ALSVectorLearner,
    MCMCVectorLearner,
)
from libfm_tpu_torch.learners.sgd import SGDLearner  # noqa: E402
from libfm_tpu_torch.learners.sgda import SGDALearner  # noqa: E402
from libfm_tpu_torch.models.fm import (  # noqa: E402
    FMConfig,
    FMParams,
    fm_batch_predict,
    init_fm,
)
from libfm_tpu_torch.tasks import (  # noqa: E402
    TASK_CLASSIFICATION,
    TASK_REGRESSION,
)

__all__ = [
    "Dataset",
    "FMParams",
    "FMConfig",
    "init_fm",
    "fm_batch_predict",
    "MCMCLearner",
    "ALSLearner",
    "MCMCVectorLearner",
    "ALSVectorLearner",
    "SGDLearner",
    "SGDALearner",
    "resolve_device",
    "TASK_REGRESSION",
    "TASK_CLASSIFICATION",
]
