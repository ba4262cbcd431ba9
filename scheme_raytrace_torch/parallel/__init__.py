from .mesh import make_mesh  # noqa: F401
from .pool import render_pool_balanced, render_pool_sharded  # noqa: F401
from .render import (render_sharded, train_step,  # noqa: F401
                     train_step_fused, calibrate_iters_sharded)  # noqa: F401
