"""K4's backward kernel (``csrc/rglru_scan_bwd.cu``): its launch layout on the CPU.

``rg.bwd_geometry`` mirrors the plan the kernel makes for itself (its CTAs,
threads, stage, ring, shared bytes and CTAs an SM); the card tests
(``tests/test_torch_cuda.py``) hold the built library's plan to it.  Here:
the layout fills the H100 in one wave at recurrentgemma-2b's training
shape, never depends on T or the T tile, never crosses a C tile, sizes the
checkpoint workspace, and refuses what the kernel refuses.  The card tests
also run a ragged last stage through the ring (T = 600).  The backward's
values are held against ``jax.vjp`` of the reference in
``tests/test_torch_backward.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg

#: the H100's SMs
SMS = 132


def _default_tile_c(b, t, c, dtype=torch.bfloat16):
    return ops.schedule_for(ops.instance("rglru_scan", dtype, T=t, C=c, B=b)).t["C"]


def test_bwd_geometry_fills_the_card_at_the_training_shape():
    """recurrentgemma-2b trains at 4·512·2560: 80 CTAs a batch row under the
    default 512-channel tile, 320 in all, at least 3 an SM, so one wave."""
    b, t, c = 4, 512, 2560
    geo = rg.bwd_geometry(b, t, c, _default_tile_c(b, t, c), torch.bfloat16)
    assert geo["ctas"] == 320
    assert geo["resident"] >= 3 and geo["ctas"] <= SMS * geo["resident"]
    assert (geo["threads"], geo["stage_t"], geo["ring"]) == (rg.BWD_THREADS, rg.BWD_STAGE_T, rg.BWD_RING)
    assert geo["checkpoints"] == (b, 15, c)


@pytest.mark.parametrize("dtype,resident", [(torch.bfloat16, 3), (torch.float32, 2)])
def test_bwd_shared_bytes_decide_residency(dtype, resident):
    """The shared bytes (a CTA's 1 KiB reserve included) leave room for 3
    CTAs an SM in bf16 and 2 in f32; the threads would allow more."""
    geo = rg.bwd_geometry(4, 512, 2560, 512, dtype)
    assert geo["resident"] == resident
    assert resident * (geo["smem"] + rg.CTA_SMEM_RESERVE) <= rg.SM_SMEM
    assert (resident + 1) * (geo["smem"] + rg.CTA_SMEM_RESERVE) > rg.SM_SMEM
    assert rg.SM_THREADS // geo["threads"] > resident


@pytest.mark.parametrize("b,c,tile_c", [(4, 2560, 512), (1, 2560, 2560), (2, 100, 48), (3, 12, 8),
                                        (1, 40, 64)])
def test_bwd_geometry_does_not_depend_on_t_or_the_t_tile(b, c, tile_c):
    """Only the checkpoints follow T; the CTAs are the forward's, whatever
    the T tile."""
    base = rg.bwd_geometry(b, 256, c, tile_c, torch.bfloat16)
    for t in (1, 31, 32, 33, 37, 97, 512, 600):
        geo = rg.bwd_geometry(b, t, c, tile_c, torch.bfloat16)
        assert {k: v for k, v in geo.items() if k != "checkpoints"} == \
            {k: v for k, v in base.items() if k != "checkpoints"}
        for tile_t in {1, 8, t}:
            assert geo["ctas"] == rg.scan_geometry(b, t, c, tile_t, tile_c)[2]


@pytest.mark.parametrize("c,tile_c", [(2560, 512), (2560, 2560), (2560, 8), (100, 48), (12, 8),
                                      (40, 64), (97, 33)])
def test_bwd_ctas_never_cross_a_c_tile(c, tile_c):
    """A CTA a part of one C tile (``cta_channels``), per batch row."""
    ranges = rg.cta_channels(c, tile_c)
    assert rg.bwd_geometry(3, 7, c, tile_c, torch.bfloat16)["ctas"] == 3 * len(ranges)
    for rng in ranges:
        if len(rng):
            assert len(rng) <= rg.CTA_C
            assert rng.start // tile_c == (rng.stop - 1) // tile_c


@pytest.mark.parametrize("t,planes", [(1, 0), (31, 0), (32, 0), (33, 1), (37, 1), (512, 15)])
def test_bwd_checkpoint_shape(t, planes):
    """One f32 state a channel at the start of every 32-token stage but the
    last (the reverse walk starts that one from the forward walk's state)."""
    assert rg.bwd_geometry(2, t, 2560, 512, torch.float32)["checkpoints"] == (2, planes, 2560)


@pytest.mark.parametrize("args", [(0, 8, 64, 32, torch.bfloat16), (1, 0, 64, 32, torch.bfloat16),
                                  (1, 8, 0, 32, torch.bfloat16), (1, 8, 64, 0, torch.bfloat16),
                                  (65536, 8, 64, 32, torch.bfloat16), (1, 8, 64, 32, torch.float16)])
def test_bwd_geometry_refuses_invalid_arguments(args):
    with pytest.raises(ValueError):
        rg.bwd_geometry(*args)
