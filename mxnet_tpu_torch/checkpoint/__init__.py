"""Fault-tolerant checkpointing & auto-resume.

The durable-state subsystem: async atomic snapshots, CRC-validated
restore with fallback, retention GC, auto-resume wiring for
``gluon.Trainer`` / ``Module.fit(checkpoint_dir=...)`` / the serving
``BucketedPredictor`` hot reload, and a SIGTERM/atexit emergency-save
hook (the port of ``mxnet_tpu/checkpoint/``; directories move between
the two packages either way).

Quick start::

    import mxnet_tpu_torch as mx
    mgr = mx.checkpoint.CheckpointManager("ckpts", max_to_keep=5,
                                          keep_period=1000)
    start = mx.checkpoint.restore_or_initialize(
        mgr, net, trainer, initializer=mx.init.Xavier()) or 0
    stop = mx.checkpoint.install_preemption_hook(
        mgr, lambda: (step, {"param:" + k: p.data()
                             for k, p in net.collect_params().items()}))
    for step in range(start, total):
        ...
        if step % 200 == 0:
            mx.checkpoint.save_trainer(mgr, step, net, trainer)
    mgr.wait()
"""
from .layout import (CheckpointInvalidError, all_steps, latest_step,
                     load_checkpoint_dir, quick_validate, read_manifest,
                     step_dirname)
from .manager import (ARG_PREFIX, AUX_PREFIX, OPTIMIZER_STATES_KEY,
                      PARAM_PREFIX, SYMBOL_KEY, TRAINER_STATES_KEY,
                      CheckpointError, CheckpointManager, env_manager,
                      pack_module_state, restore_or_initialize,
                      restore_trainer, save_trainer, unpack_module_state)
from .hooks import install_preemption_hook

__all__ = [
    "CheckpointManager", "CheckpointError", "CheckpointInvalidError",
    "all_steps", "latest_step", "step_dirname", "read_manifest",
    "quick_validate", "load_checkpoint_dir", "env_manager",
    "save_trainer", "restore_trainer", "restore_or_initialize",
    "pack_module_state", "unpack_module_state",
    "install_preemption_hook",
    "PARAM_PREFIX", "ARG_PREFIX", "AUX_PREFIX", "TRAINER_STATES_KEY",
    "OPTIMIZER_STATES_KEY", "SYMBOL_KEY",
]
