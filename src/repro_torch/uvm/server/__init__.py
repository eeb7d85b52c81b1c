"""Async fault-stream serving (port of ``repro.uvm.server``): many
concurrent JSONL clients, one cross-connection microbatched model dispatch
per tick.

The package splits the ``cli serve`` sidecar into reusable layers:

* :mod:`~repro_torch.uvm.server.protocol` — the versioned JSONL line codec
  (observe / feedback / hello records, structured error lines) shared by
  ``cli serve``, the async server, and the load generator.
* :mod:`~repro_torch.uvm.server.session` — :class:`StreamSession`, a
  sans-io per-connection state machine that turns input lines into staged
  ``evaluate_many`` / ``train_group_many`` ticks and folds results back
  into action records.  ``cli serve`` drives one session inline; the
  server drives many through a shared dispatcher.
* :mod:`~repro_torch.uvm.server.core` — :class:`FaultStreamServer`, the
  asyncio accept loop + :class:`MicrobatchDispatcher` lockstep engine that
  batches every session's staged halves through one ``Trainer.
  evaluate_many`` / ``train_group_many`` call per tick, on one worker
  thread that alone touches the card.
* :mod:`~repro_torch.uvm.server.loadgen` — a deterministic multi-client
  load generator replaying exported fault logs at a target rate (a client:
  no torch, no device).
* :mod:`~repro_torch.uvm.server.aot` — the compile-once cache: the kernel
  library built into, and loaded from, a cache directory.
"""
from repro_torch.uvm.server.aot import AotCache, enable_aot
from repro_torch.uvm.server.core import FaultStreamServer, MicrobatchDispatcher, ServerConfig
from repro_torch.uvm.server.loadgen import LoadStats, make_connector, run_loadgen
from repro_torch.uvm.server.protocol import ProtocolError, decode_line, encode_error, encode_record
from repro_torch.uvm.server.session import EvalTick, StreamSession, SyncDispatch, TrainTick, drive

__all__ = [
    "AotCache",
    "EvalTick",
    "FaultStreamServer",
    "LoadStats",
    "MicrobatchDispatcher",
    "ProtocolError",
    "ServerConfig",
    "StreamSession",
    "SyncDispatch",
    "TrainTick",
    "decode_line",
    "drive",
    "enable_aot",
    "encode_error",
    "encode_record",
    "make_connector",
    "run_loadgen",
]
