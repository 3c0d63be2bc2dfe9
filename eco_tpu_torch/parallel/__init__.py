from eco_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SEGMENT_AXIS,
    batch_sharding,
    distributed_init,
    make_mesh,
    mesh_shape,
    replicated,
)
from eco_tpu_torch.parallel.shard import (
    make_segment_sharded_infer_fn,
    make_segment_sharded_train_step,
    make_sharded_infer_fn,
    make_sharded_train_step,
    shard_batch,
)
from eco_tpu_torch.parallel.pp import (
    Stage,
    make_pp_infer_fn,
    split_stages,
)
from eco_tpu_torch.parallel.tp import (
    make_tp_infer_fn,
    make_tp_train_step,
    shard_tp_train_state,
    shard_tp_tree,
    tp_spec_tree,
)
