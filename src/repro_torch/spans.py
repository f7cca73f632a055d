"""The program's spans on ``torch.profiler``'s timeline.

``span(name)`` is a user-annotation range, the one
``torch.profiler.record_function`` opens, while a profiler records in the
process, and one shared null context otherwise: outside a profiler a span
costs a flag read.  The range is opened through the pair of calls
``record_function`` itself makes underneath, without its Python and
dispatcher layers, which cost three times as much a span under a profiler
and slow a traced server enough to change what the trace shows.  An
operator who runs ``torch.profiler.profile`` around the server sees these
ranges beside the kernels and copies they launch, on the profiler's own
clock; a span's count in the trace counts what it covers (checksum passes
a batch, the requests' copies a batch).

Every span, where it is opened, and what it covers:

- ``serve/step``: ``CnnServingEngine.step``, one dispatch.  A batch's
  spans all nest under its step: the batch's root span.
- ``serve/submit``: ``CnnServingEngine.submit``, admission of one request.
- ``serve/upload``: the request's copy to the engine's device.
- ``chain/infer``: the engine's call of ``ChainRuntime.infer``, the chain
  runtime serving one batch.
- ``chain/stage``: ``ChainRuntime._run``, one tier's stage.
- ``model/conv``: ``models/cnn.py::apply_cnn``, one conv layer or
  inverted-residual block, fused epilogue included, around its call into
  the conv kernel.
- ``model/linear``: the classifier layer, its weight's cast included.
- ``codec/encode``: ``runtime/wire.py::encode_boundary``, one boundary.
- ``codec/to_host``: the encoded buffer's copy to pinned host memory and
  the wait on the stream.
- ``codec/pack``: framing the int8 payload (``pack_frames``).
- ``link/send``: ``runtime/transfer.py::send_with_retry``, one logical
  transfer with its retries.
- ``link/transmit``: one attempt on the virtual link.
- ``link/checksum``: one crc32 pass over a payload or a frame.
- ``codec/decode``: ``decode_boundary``, one boundary.
- ``codec/upload``: the decoded boundary's trip back to the device, from
  filling the pinned buffer through the dequantize launch."""
from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
_enter = torch.autograd._record_function_with_args_enter
_exit = torch.autograd._record_function_with_args_exit


class _Range:
    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = _enter(self.name)

    def __exit__(self, *exc):
        _exit(self.handle)


def span(name: str):
    """A user-annotation range named ``name`` while a profiler records,
    else a shared null context."""
    return _Range(name) if _recording() else _NULL
