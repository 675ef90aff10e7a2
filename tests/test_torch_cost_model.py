"""The port's analytic stage cost model against the reference's XLA
``cost_analysis`` counts — the FLOPs behind the simulated clock.

Tolerance: the device-stage FLOPs and the smashed bytes are exact. The
server stage (which holds the loss) is held to one float32 ulp of the
reference's count (at most 1.2e-7 relative): XLA adds its
per-instruction counts in float32, in its own instruction order; the
port rounds the exact integer count to float32 once. The two agree
exactly for SP2 and SP3 here, and differ by one ulp for SP1 at B=50
and B=100 (64 and 128 FLOPs in about 1e9)."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.core import split as ref_split
from repro.models.vgg import VGG5 as RefVGG5
from repro.runtime.cluster import StageCostModel as RefCostModel
from repro_torch.runtime.cluster import StageCostModel
from repro_torch.models.vgg import VGG5


@pytest.fixture(scope="module")
def ref_setup():
    m = RefVGG5()
    return m, m.init(jax.random.PRNGKey(0)), RefCostModel()


@pytest.fixture(scope="module")
def port_model():
    return VGG5(device="cpu")


@pytest.mark.parametrize("sp", [1, 2, 3])
@pytest.mark.parametrize("B", [16, 50, 100])
def test_stage_costs_match_xla(ref_setup, port_model, sp, B):
    m, params, ref_cm = ref_setup
    batch = {"images": np.zeros((B, 32, 32, 3), np.float32),
             "labels": np.zeros((B,), np.int32)}
    d, s = ref_split.partition_params(m, params, sp)
    r_dev, r_srv, r_bytes = ref_cm.costs(m, d, s, batch, sp)
    dev, srv, nbytes = StageCostModel().costs(port_model, None, None, batch,
                                              sp)
    assert dev == r_dev
    assert nbytes == r_bytes
    assert abs(srv - r_srv) <= np.spacing(np.float32(r_srv))
    if sp > 1:
        assert srv == r_srv


def test_device_stage_is_linear_in_batch(port_model):
    cm = StageCostModel()
    one = cm.costs(port_model, None, None,
                   {"images": np.zeros((1, 32, 32, 3))}, 2)[0]
    assert cm.costs(port_model, None, None,
                    {"images": np.zeros((16, 32, 32, 3))}, 2)[0] == 16 * one
    # the docstring's worked example: SP1 at B=16
    assert cm.costs(port_model, None, None,
                    {"images": np.zeros((16, 32, 32, 3))}, 1)[0] == \
        2 * 3 * 32 * 94 ** 2 * 16 + 16 * (32768 + 32768 + 24576)
