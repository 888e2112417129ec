"""Meshes, the process-group bring-up and sharded FedAvg (port of
``frp_tpu/parallel``)."""

from frp_tpu_torch.parallel.fedavg import fedavg_sharded, pad_clients
from frp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    data_rows,
    distributed_initialize,
    make_global_mesh,
    make_mesh,
    model_columns,
)
