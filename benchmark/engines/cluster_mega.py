"""Engine ``cluster_mega``: whole paths through the cluster walk (kernel
3), ``render_cli``'s ``engine == "cluster-mega"`` branch: one
``render_cluster_mega`` launch a step."""

from __future__ import annotations

from benchmark.engines.program import build_inputs, step_kwargs


def build(scene: dict, cfg: dict, device, span):
    from mcpt_torch.kernels import cluster_megakernel as cmk

    with span("scene_build"):
        prog_scene, lights, cam = build_inputs(scene, cfg, device)
        cms = cmk.build_cluster_megascene(prog_scene, lights)
    kw = step_kwargs(cfg)
    w, h = cfg["width"], cfg["height"]

    def step(seed, spp):
        return cmk.render_cluster_mega(cms, cam, w, h, spp=spp, seed=seed,
                                       **kw)

    return step
