"""Plain PyTorch versions of the kernels, under the reference oracles' names
(``repro.kernels.ref``).  Each lives beside its kernel; this module only
re-exports them."""
from ..core.quant import dequantise_rows as dequant_tau
from .choice_info import choice_info_plain as choice_info
from .fused_select import fused_select_plain as fused_select
from .fused_select import fused_select_quant_plain as fused_select_quant
from .pheromone_update import pheromone_update_plain as pheromone_update
from .sparse_select import sparse_select_plain as sparse_select
from .sparse_select import sparse_select_quant_plain as sparse_select_quant
from .tour_select import tour_select_plain as tour_select
from .two_opt import select_move
from .two_opt import two_opt_best_plain as two_opt_best

__all__ = ["choice_info", "dequant_tau", "fused_select", "fused_select_quant",
           "pheromone_update", "select_move", "sparse_select",
           "sparse_select_quant", "tour_select", "two_opt_best"]
