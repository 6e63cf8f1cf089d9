"""Engine ``hybrid_mesh``: the hybrid over a mesh of ranks,
``render_cli``'s mesh branch for ``engine == "hybrid"``.  Every rank
builds the scene and, on CUDA, runs the pilot for its own compaction caps;
a step is ``dist.render_hybrid_sharded``: the rank's share of the samples
(kernel 2 and the stages between bounces on its slice of the tile order),
summed over the mesh's ``samples`` axis, with the mesh's segment count."""

from __future__ import annotations

from benchmark.engines.program import build_inputs, step_kwargs


def build(scene: dict, cfg: dict, device, span, mesh):
    from mcpt_torch import dist
    from mcpt_torch.kernels import cluster_megakernel as cmk
    from mcpt_torch.render import integrator as integ

    with span("scene_build"):
        prog_scene, lights, cam = build_inputs(scene, cfg, device)
        cms = cmk.build_cluster_megascene(prog_scene, lights)
    kw = step_kwargs(cfg)
    # the sharded hybrid renders at the kernels' t_min
    if kw.pop("t_min") != 1e-4:
        raise ValueError("render_hybrid_sharded takes no t_min: the "
                         "configuration's has to be 1e-4")
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
        return dist.render_hybrid_sharded(cms, cam, w, h, spp, mesh,
                                          seed=seed, **kw)

    return step
