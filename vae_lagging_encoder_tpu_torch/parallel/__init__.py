"""Data and tensor parallelism over ``torch.distributed`` (one process per
rank; ``launch.run_ranks`` starts them)."""
from .dp import (EmulatedNoise, Mesh, all_reduce, emulated_dp_loss, make_dp_train_step,
                 make_mesh, make_tp_mesh, reduce_grads, shard_batch, shard_rows)
from .launch import RankOutcome, choose_backend, run_ranks
from .tp import (clip_scale_tp, clip_tp, gather_tree, make_tp_eval_step, make_tp_loss_fn,
                 make_tp_train_step, shard_model, shard_tree, tp_nll_iw, tp_reconstruct_error,
                 tp_token_logp)

__all__ = ["EmulatedNoise", "Mesh", "RankOutcome", "all_reduce", "choose_backend",
           "clip_scale_tp", "clip_tp", "emulated_dp_loss", "gather_tree", "make_dp_train_step",
           "make_mesh", "make_tp_eval_step", "make_tp_loss_fn", "make_tp_mesh",
           "make_tp_train_step", "reduce_grads", "run_ranks", "shard_batch", "shard_model",
           "shard_rows", "shard_tree", "tp_nll_iw", "tp_reconstruct_error", "tp_token_logp"]
