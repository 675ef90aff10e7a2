"""LR schedules. The paper trains at a constant rate; ``constant`` maps
a step to that rate as a Python float rounded to float32, the value
``repro.optim.schedules.constant`` yields. The cosine and WSD schedules
of the LLM-scale architectures are not ported yet."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda step: float(np.float32(lr))
