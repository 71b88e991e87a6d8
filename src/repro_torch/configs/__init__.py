"""Architecture registry: the 10 assigned archs + paper GBDT workloads.

`ARCHS`, `SMOKES` and `get` behave as the JAX package's; the paper's GBDT
workloads are in `configs.gbdt_workloads`."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                      SUBQUADRATIC, applicable_shapes)
from repro_torch.configs import (glm4_9b, granite_34b, internlm2_20b,
                                 internvl2_1b, kimi_k2_1t_a32b, mamba2_1p3b,
                                 mixtral_8x22b, stablelm_12b, whisper_small,
                                 zamba2_1p2b)

_MODULES = [internlm2_20b, glm4_9b, stablelm_12b, granite_34b, zamba2_1p2b,
            mamba2_1p3b, kimi_k2_1t_a32b, mixtral_8x22b, internvl2_1b,
            whisper_small]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]
