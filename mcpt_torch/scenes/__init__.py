from mcpt_torch.scenes.procedural import (  # noqa: F401
    boxfield,
    cornell_box,
    diningroom,
    furnace_sphere,
    quad_light_plane,
    veach_mis,
)
