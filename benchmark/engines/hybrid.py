"""Engine ``hybrid``: the fused-bounce pipeline (kernel 2 a bounce, with
the torch stages around it), ``render_cli``'s ``engine == "hybrid"``
branch: on CUDA the pilot (``measure_hybrid_schedule``) sets the pool's
compaction caps once, before the first step."""

from __future__ import annotations

from benchmark.engines.program import build_inputs, step_kwargs


def build(scene: dict, cfg: dict, device, span):
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ

    with span("scene_build"):
        prog_scene, lights, cam = build_inputs(scene, cfg, device)
        cms = cmk.build_cluster_megascene(prog_scene, lights)
    kw = step_kwargs(cfg)
    if device.type == "cuda":
        integrator = cfg["integrator"]
        opts = integ.RenderOptions(
            max_depth=cfg["maxdepth"], nee=integrator["nee"],
            mis=integrator["mis"],
            russian_roulette=integrator["russian_roulette"],
            rr_start_depth=integrator["rr_start_depth"])
        with span("pilot"):
            kw["compact"] = integ.measure_hybrid_schedule(cms, cam, opts)
    w, h = cfg["width"], cfg["height"]

    def step(seed, spp):
        return cmk.render_hybrid(cms, cam, w, h, spp=spp, seed=seed, **kw)

    return step
