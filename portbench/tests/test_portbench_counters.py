"""The yardstick's frozen counters (each kind's, `kinds/<model>.py`) equal
the program's at the cells' shapes; the byte count of the semi-continuous
scorer is its own."""

import pytest

from portbench import counters, kinds

cont, semi = kinds.load("cont"), kinds.load("semi")


@pytest.mark.parametrize("T", [50, 9600])
def test_continuous_counters_equal_the_programs(T):
    from cmusphinx_tpu_torch.utils import mfu
    for fused in (True, False):
        assert cont.continuous_gmm_bytes(T, 6144, 8, 39, fused) == \
            mfu.continuous_gmm_bytes(T, 6144, 8, 39, fused)
    assert cont.continuous_gmm_flops(T, 6144, 8, 39) == \
        mfu.continuous_gmm_flops(T, 6144, 8, 39)


@pytest.mark.parametrize("T", [50, 9600])
def test_semi_counter_equals_the_programs(T):
    from cmusphinx_tpu_torch.utils import mfu
    assert semi.psparity_flops(T, 3, 256, [13, 13, 13], 5150, 4) == \
        mfu.psparity_flops(T, 3, 256, [13, 13, 13], 5150, 4)


def test_least_times():
    cont_shape = {"kind": "cont", "S": 6144, "K": 8, "D": 39}
    semi_shape = {"kind": "semi", "S": 5150, "K": 256,
                  "veclens": [13, 13, 13], "topn": 4}
    # K1 at a batch's T is bound by operations, at a 50-frame call by bytes.
    assert counters.score_least_s(cont_shape, 9600) == \
        cont.continuous_gmm_flops(9600, 6144, 8, 39) / counters.PEAK_TF32
    assert counters.score_least_s(cont_shape, 50) == \
        cont.continuous_gmm_bytes(50, 6144, 8, 39) / counters.HBM_BW
    by_hand = 3 * 256 * 5150 + 4 * 256 * (2 * 39 + 3) + 4 * 9600 * 39 \
        + 4 * 9600 * 5150
    assert semi.psparity_bytes(9600, 256, [13, 13, 13], 5150) == by_hand
    assert counters.score_least_s(semi_shape, 9600) == by_hand / counters.HBM_BW
