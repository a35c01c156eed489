from .model import M4Config, init_m4
from .simulate import (M4Result, M4Simulator, simulate_open_loop,
                       simulate_open_loop_batch)

__all__ = ["M4Config", "M4Result", "M4Simulator", "init_m4",
           "simulate_open_loop", "simulate_open_loop_batch"]
