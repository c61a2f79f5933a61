from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    Mesh, TP_RULES, all_reduce_grads, data_axes, gather_opt_state,
    gather_params, gather_rows, group_ranks, init_distributed, make_mesh,
    make_multislice_mesh, opt_param_names, reduce_sums, shard_batch,
    shard_model, shard_opt_state, shard_params)

__all__ = ["Mesh", "TP_RULES", "all_reduce_grads", "data_axes",
           "gather_opt_state", "gather_params", "gather_rows",
           "group_ranks", "init_distributed", "make_mesh",
           "make_multislice_mesh",
           "opt_param_names", "reduce_sums", "shard_batch", "shard_model",
           "shard_opt_state", "shard_params"]
