"""The data axis over ranks: a ``torch.distributed`` world (:mod:`.world`),
the collectives the port needs (:mod:`.comm`) and the launcher of a world
of processes (:mod:`.spawn`).

A mesh over several ranks (:func:`repro_torch.matching.make_mesh` inside a
world) cuts the matcher's edge list one shard a rank; ``build_train_step``,
``adamw_init``/``adamw_update`` and the checkpoints take a ``world`` for
data parallelism with ZeRO-1; a world of ``D x M`` ranks (``mesh=(D,
M)``) adds the model axis: tensor and sequence parallelism over ``model``
and FSDP over ``data`` (:mod:`repro_torch.models.common`'s placement).
"""
from .world import (Axis, World, choose_backend, close_world,
                    current_world, init_world, rank_devices, require_world)
from .comm import (all_gather, all_gather_into, all_reduce_max_,
                   all_reduce_min_, all_reduce_sum_, barrier, broadcast_,
                   copy_to, gather_from, reduce_from, reduce_scatter_mean,
                   reduce_scatter_sum, scatter_to, split_to)
from .spawn import RankError, run_world

__all__ = [
    "World", "init_world", "close_world", "current_world",
    "require_world", "rank_devices", "choose_backend",
    "all_reduce_min_", "all_reduce_sum_",
    "broadcast_", "reduce_scatter_mean", "all_gather_into", "barrier",
    "run_world", "RankError",
    "Axis", "all_reduce_max_", "reduce_scatter_sum", "all_gather",
    "copy_to", "reduce_from", "gather_from", "scatter_to", "split_to",
]
