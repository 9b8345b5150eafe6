"""The parallel paths on torch.distributed (x2gnn_tpu/parallel/): one
process per rank, as torchrun starts them. `mesh` lays the ranks out,
`data_parallel` shards molecules, `ep_model` the atoms of one batched
graph, `hybrid` composes the two, and `edge_partition` is the standalone
edge-partitioned attention op."""

from x2gnn_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, device_count, initialize_distributed, make_mesh)
from x2gnn_tpu_torch.parallel.data_parallel import (  # noqa: F401
    dp_batch_iterator, empty_like_batch, make_dp_eval_step,
    make_dp_train_step)
from x2gnn_tpu_torch.parallel.edge_partition import (  # noqa: F401
    make_ep_blocked_attention)
from x2gnn_tpu_torch.parallel.ep_model import (  # noqa: F401
    EPBatch, make_ep_batch, make_ep_eval_step, make_ep_forward,
    make_ep_train_step, shard_ep_batch)
from x2gnn_tpu_torch.parallel.hybrid import (  # noqa: F401
    make_hybrid_eval_step, make_hybrid_forward, make_hybrid_mesh,
    make_hybrid_train_step, shard_hybrid_batch, stack_ep_batches)
