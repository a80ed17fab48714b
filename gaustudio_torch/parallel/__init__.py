"""Multi-device parallelism on torch.distributed (port of gaustudio_tpu/parallel).

The JAX package is one process driving a device mesh through ``shard_map``.
The port is SPMD: one process per rank, launched by ``torch.distributed.run``
(torchrun), each driving its own device, over a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("dp", "gs")``:

  * ``dp`` — data parallel over cameras: each dp rank renders a different
    view against the gathered Gaussian set; gradients and metrics are
    all-reduced (mean) over dp, TSDF volumes are summed.
  * ``gs`` — the Gaussian axis: the rows of every parameter, Adam moment
    and statistic are split over gs as ``torch.tensor_split`` splits them;
    each step all-gathers the rows for rendering and keeps the gradient of
    its own rows.

``mesh`` holds the process-group set-up and the collectives, ``render_dp``
the camera-parallel render and TSDF fusion, ``train_dp`` the sharded
training step and ``DPTrainer``, ``dryrun`` a launcher of n ranks and the
dry run of every path.
"""

from gaustudio_torch.parallel.mesh import make_mesh  # noqa: F401
