from mcpt_torch.io.objloader import load_object  # noqa: F401
from mcpt_torch.io import image  # noqa: F401
