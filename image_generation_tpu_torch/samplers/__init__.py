"""Sampler backends (the annealer-replacement layer).

Importing this package imports the backends' modules; each imports only
torch and numpy.
"""

from image_generation_tpu_torch.samplers.base import SamplerBackend, get_sampler  # noqa: F401
from image_generation_tpu_torch.samplers.exact_sampler import ExactSampler  # noqa: F401
from image_generation_tpu_torch.samplers.factory import get_sampler_and_graph  # noqa: F401
from image_generation_tpu_torch.samplers.gibbs_sampler import (  # noqa: F401
    GibbsSampler,
    PTSampler,
)
from image_generation_tpu_torch.samplers.persistent import (  # noqa: F401
    PersistentSampleCache,
    push_to_deque,
)
