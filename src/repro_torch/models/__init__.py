"""Model substrate: unified LM stack for the 10 assigned architectures."""
from repro_torch.models import (layers, moe, ssm, steps,  # noqa: F401
                                transformer)
