"""Fault-stream serving (port of ``repro.uvm.server``, so far the parts
``cli serve`` runs on):

* :mod:`~repro_torch.uvm.server.protocol` — the JSONL line codec (observe /
  feedback / hello records, structured error lines);
* :mod:`~repro_torch.uvm.server.session` — :class:`StreamSession`, the
  sans-io per-connection state machine that turns input lines into staged
  ``evaluate_many`` / ``train_group_many`` ticks and folds their results
  back into action records.

The reference's async server, load generator and AOT cache
(``core.py``, ``loadgen.py``, ``aot.py``) are not ported yet.
"""
from repro_torch.uvm.server.protocol import ProtocolError, decode_line, encode_error, encode_record
from repro_torch.uvm.server.session import EvalTick, StreamSession, SyncDispatch, TrainTick, drive

__all__ = [
    "EvalTick",
    "ProtocolError",
    "StreamSession",
    "SyncDispatch",
    "TrainTick",
    "decode_line",
    "drive",
    "encode_error",
    "encode_record",
]
