"""Data-parallel rendering and acquisition over ``torch.distributed``.

Counterpart of ``tpu_rt/parallel/``: where tpu_rt shards work over a
device mesh with ``shard_map`` and reduces with ``psum``, each rank of a
process group traces its slice of the work through the same kernel as the
single-process route and one collective reduces the films or the RF
(``render.py``: the optical routes and the collectives; ``ultrasound.py``:
the acquisition's two routes and the DAS; ``dryrun.py``: the steps of
tpu_rt's multi-chip dry run in spawned processes).  The caller starts the
group (``torch.distributed.init_process_group``: one process per GPU
under NCCL, or gloo, which also takes CPU tensors); a sharded function
with no group raises.
"""
