"""The roofline counts against hand counts: no padded slot or group, no
repeated pass, no CSR or order bytes."""

import numpy as np
import pytest
import torch

from portbench import roofline as R


def test_counts_by_hand():
    # 3 groups of 4 slots, S = 2; visibility 1 has no weight, 5 marks an empty slot
    cg_idx = torch.tensor([[0, 1, 5, 5], [5, 5, 5, 5], [2, 3, 4, 5]])
    wgt = torch.tensor([1.0, 0.0, 1.0, 1.0, 1.0])
    c = R.idg_counts(cg_idx, [(0, 2), (2, 1)], wgt, S=2, nbig=(4, 4))
    # 4 live slots in 2 groups: 8 (S^2 slots + 2 S^3 groups) = 8 (16 + 32)
    assert c["b1"] == c["b2"] == (384, 8 * 4 + 8 * 4 * 2)
    # each bin holds one group with a live slot: its patch and the bin's grid
    assert c["k1"] == (2 * 4 * 2, 2 * (8 * 4 + 8 * 16))
    assert c["k2"] == (0, c["k1"][1])


def test_bound_and_share():
    ops, nbytes = 495e12, 3.35e12 / 2
    assert R.bound_seconds(ops, nbytes) == pytest.approx(1.0)
    assert R.roofline_percent(ops, nbytes, 2.0) == pytest.approx(50.0)
    assert R.roofline_percent(ops, nbytes, 0.0) is None


def test_a_plan_padded_in_place_counts_as_the_unpadded_plan():
    from pfb_imaging_tpu_torch.ops.gridder_idg import plan_idg
    from pfb_imaging_tpu_torch.parallel.sharded import _pad_to_caps

    from portbench import data

    torch.set_num_threads(2)
    uvw = data.synth_array(10, 12, 42, 1.0)
    freq = data.channels(4, 856e6, 1712e6)
    kw = dict(nx=64, ny=64, cellx=4e-6, celly=4e-6, epsilon=1e-7, divide_by_n=False, device="cpu")
    p = plan_idg(uvw, freq, **kw)
    wgt = np.ones((uvw.shape[0], freq.size))
    wgt[::3] = 0.0  # some visibilities carry no weight
    before = R.plan_counts(p, wgt)
    caps = tuple(c + 5 for c in p.bin_gcount)
    _pad_to_caps(p, caps, p.scal.new_zeros((4, sum(caps), p.G)))
    assert p.ngroups == sum(caps)
    assert R.plan_counts(p, wgt) == before
    assert before["b1"][0] > 0 and before["k1"][1] > 0
