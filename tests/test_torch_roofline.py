"""The port's model accounting (``repro_torch.roofline.analysis``):
``count_params``, ``active_params`` and ``model_flops`` equal to the
reference's for every config, at full width and at the smoke width
(exact integers and floats)."""
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import smoke_config as ref_smoke_config
from repro.roofline import analysis as ref
from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.roofline import analysis as port
from repro_torch.zoo import get_api

from _torch_model_cases import ref_get_api


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_counts_and_flops_equal_the_reference(arch, smoke):
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    if smoke:
        cfg, rcfg = smoke_config(cfg), ref_smoke_config(rcfg)
    specs = get_api(cfg).param_specs(cfg)
    rspecs = ref_get_api(rcfg).param_specs(rcfg)
    n, rn = port.count_params(specs), ref.count_params(rspecs)
    a, ra = port.active_params(cfg, specs), ref.active_params(rcfg, rspecs)
    assert type(n) is int and n == rn and a == ra and 0 < a <= n
    for name, shape in SHAPES.items():
        got = port.model_flops(cfg, shape, n, a)
        assert got == ref.model_flops(rcfg, REF_SHAPES[name], rn, ra)


def test_qwen25_3b_size():
    cfg = ARCHS["qwen2.5-3b"]
    n = port.count_params(get_api(cfg).param_specs(cfg))
    assert 3.0e9 < n < 3.2e9           # about 3.09 B, 6.17 GB in bfloat16
