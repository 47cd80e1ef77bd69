"""Plain PyTorch versions of the kernels, under the reference oracles' names
(``repro.kernels.ref``).  Each lives beside its kernel; this module only
re-exports them."""
from .choice_info import choice_info_plain as choice_info
from .fused_select import fused_select_plain as fused_select
from .pheromone_update import pheromone_update_plain as pheromone_update
from .tour_select import tour_select_plain as tour_select

__all__ = ["choice_info", "fused_select", "pheromone_update", "tour_select"]
