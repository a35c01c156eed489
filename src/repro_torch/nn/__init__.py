from .layers import (gru_cell, gru_init, lecun_normal, linear, linear_init,
                     mlp, mlp_init)

__all__ = ["gru_cell", "gru_init", "lecun_normal", "linear", "linear_init",
           "mlp", "mlp_init"]
