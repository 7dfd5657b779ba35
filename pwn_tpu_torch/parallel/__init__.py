"""Multi-device execution of the port: the process grid and data
parallelism (`mesh.py`), the model axis's state sharding and batch-sharded
generation (`tp.py`), and sequence-parallel generation (`sp.py`).

The names below load on first touch: `tp.py` builds on
`training/common.py`, which itself imports `mesh.py`.
"""

_LAZY = {
    **dict.fromkeys(
        ("ProcessGrid", "ensure_distributed", "local_batch_size",
         "mesh_shape", "process_count", "process_grid", "process_index"),
        "pwn_tpu_torch.parallel.mesh"),
    **dict.fromkeys(
        ("ModelShard", "gather_state", "global_noise",
         "make_batch_sharded_generate", "param_spec", "shard_state",
         "state_bytes", "validate_tp"),
        "pwn_tpu_torch.parallel.tp"),
    **dict.fromkeys(
        ("Exchange", "local_window", "make_sp_generate",
         "make_sp_generate_mega", "run_in_group", "run_in_process",
         "shard_mel_time", "sp_generate_in_process", "sp_mega_geometry",
         "sp_program", "validate_sp", "validate_sp_mega"),
        "pwn_tpu_torch.parallel.sp"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'pwn_tpu_torch.parallel' has no attribute {name!r}")
