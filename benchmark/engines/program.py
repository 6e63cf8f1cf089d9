"""What every engine adapter hands the program: the benchmark's raw scene
as the program's scene, lights and camera, and the step's integrator
arguments, as ``render_cli`` builds them from a config entry."""

from __future__ import annotations


def build_inputs(scene: dict, cfg: dict, device):
    """→ (Scene, Lights, Camera) of ``mcpt_torch`` on ``device``."""
    from mcpt_torch.config import CameraConfig
    from mcpt_torch.render.camera import make_camera
    from mcpt_torch.scene import build_scene, loaded_from_arrays

    loaded = loaded_from_arrays(*(scene[k] for k in (
        "verts", "mat_id", "mtype", "kd", "ks", "ka", "ns", "ni")))
    prog_scene, lights = build_scene(loaded, cfg["bvhtype"], device=device)
    cam = make_camera(CameraConfig(resolution=(cfg["width"], cfg["height"]),
                                   **scene["camera"]), device=device)
    return prog_scene, lights, cam


def step_kwargs(cfg: dict) -> dict:
    """``render_cli``'s per-step arguments of every kernel engine (its
    ``t_min`` is the kernels' default, which the configuration states)."""
    integ = cfg["integrator"]
    return dict(max_depth=cfg["maxdepth"], rr=integ["russian_roulette"],
                rr_start=integ["rr_start_depth"], nee=integ["nee"],
                mis=integ["mis"], clamp=integ["clamp"], t_min=cfg["t_min"])
