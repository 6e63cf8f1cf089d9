"""Engine ``mega``: the dense megakernel (kernel 1), ``render_cli``'s
``engine == "mega"`` branch: one ``render_mega`` launch a step."""

from __future__ import annotations

from benchmark.engines.program import build_inputs, step_kwargs


def build(scene: dict, cfg: dict, device, span):
    """→ step(seed, spp) → (radiance sum (W·H, 3), segments 0-d)."""
    from mcpt_torch.kernels import megakernel as mk

    with span("scene_build"):
        prog_scene, lights, cam = build_inputs(scene, cfg, device)
        mega = mk.build_megascene(prog_scene, lights)
    kw = step_kwargs(cfg)
    w, h = cfg["width"], cfg["height"]

    def step(seed, spp):
        return mk.render_mega(mega, cam, w, h, spp=spp, seed=seed, **kw)

    return step
