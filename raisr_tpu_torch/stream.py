"""Pipelined video processing: overlap host I/O with device compute.

Port of raisr_tpu/stream.py. The reference overlaps work with a thread pool
inside one frame (Raisr.cpp:1369-1394) and tells users to run N ffmpeg
processes for throughput (docs/performance.md:8). Here CUDA's asynchronous
launches give inter-frame pipelining: keep a bounded queue of in-flight
dispatches and only materialize them to host `depth` dispatches later.

Every dispatch rides the engine's device-resident step
(`process_batch_device`: packed integer planes in, packed integer planes out,
Y + UV) so the copies in both directions move uint8/uint16 planes, never the
float32 pipeline's.

On a CUDA engine a dispatch owns its host buffers: the group's frames are
staged into page-locked (pinned) tensors and copied with non_blocking=True,
the outputs are copied into fresh pinned tensors, and a CUDA event recorded
behind those copies marks the dispatch done. `_wait` waits on that event,
never on the device, and hands out numpy views of the dispatch's own output
tensors. The pinned tensors come from PyTorch's caching host
allocator, which hands a block out again only when nothing refers to it and
the copy that last used it has finished on the device, so a slot can be
neither refilled under a copy in flight nor overwritten while a caller still
holds its frames; in the steady state `depth + 1` sets of blocks circulate.
Only pinned memory makes a copy asynchronous; from or to pageable memory
`non_blocking` blocks the host. The staging copy is the host's largest cost
a group (~2.2 ms for four 1080p frames on one thread of an H100's host,
PERF.md), so the frames of a group are shared out over up to
`STAGE_THREADS` threads, the caller's among them (numpy copies with the GIL
released); the pool lives as long as one `process` call.

The copies in run on one side stream and the copies out on another, so group
k+1's frames arrive and group k-1's leave while group k's kernels run on the
current stream; each copy is ordered against the step by `wait_stream`, and
a dispatch keeps its device tensors until it is waited on (its event is
behind every use of them on any stream), so the caching device allocator
cannot hand their memory out again while another stream still uses it. With
everything on one stream the host's staging and read-back would still
overlap the device's work, but the copies would run between the steps: on an
H100 that costs a seventh of the rate at 1080p -> 4K (PERF.md).

On a CPU engine it is the same loop on plain tensors. A sharded engine
(`RaisrEngine(shard=...)`) takes the same dispatches: a group goes through
`process_batch_device`, whose `process_batch_y` spreads it over the mesh (the
tail is padded to `batch`, so the data axis divides it); at batch 1 each
frame goes through the per-plane entry points instead (`_dispatch_sharded`:
a data axis over 1 cannot divide a batch of one; `upscale_y` cuts the frame
into row stripes). Staging, copies and events stay on the engine's device.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from raisr_tpu_torch.engine import RaisrEngine, Frame
from raisr_tpu_torch.ops.cuda.upscale import pack_planes, unpack_planes
from raisr_tpu_torch.utils.profiler import Tracer

# threads that copy a group's frames into its pinned planes, the caller's
# among them: one thread's copy alone would bound the stream's rate
STAGE_THREADS = 4


@dataclass
class _InFlight:
    """One dispatch: its output planes on the host ([N, H, W] each; pinned
    and still being written until `done` on a CUDA engine), the event behind
    its last copy, how many of the N frames are real, and the device tensors
    its copies read and write, held until `done`."""

    y: torch.Tensor
    u: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    done: Optional["torch.cuda.Event"]
    n_real: int
    device_tensors: tuple = ()


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np.dtype(np_dtype).newbyteorder("="))).dtype


class StreamProcessor:
    """Process an iterator of Frames with `depth` dispatches in flight.

    batch > 1 groups `batch` frames into ONE device-step dispatch (the Y
    stack rides the guard-banded batched kernel): per-frame outputs are
    exactly the single-frame results, at batched throughput. This replaces
    the reference's N-parallel-ffmpeg-processes recipe
    (docs/performance.md:8).

    On a CUDA engine the yielded planes are views of page-locked memory that
    stays locked for as long as the caller keeps them; copy a frame that is
    to be kept for long.

    `tracer`'s stages, each also the span `raisr.stream.<stage>` under a
    torch.profiler: "dispatch" a group (holding "stage", the group's staging
    and copies in), and "wait" a group (its event and the numpy views; the
    time the caller holds the frames is in no stage)."""

    def __init__(self, engine: RaisrEngine, depth: int = 2, batch: int = 1,
                 tracer: Optional[Tracer] = None):
        self.engine = engine
        self.depth = max(1, depth)
        self.batch = max(1, batch)
        self.tracer = tracer or Tracer(enabled=False)
        self._threads = min(self.batch, STAGE_THREADS)
        self._cuda = engine.device.type == "cuda"
        # side streams for the copies in and out (None, as on the CPU: the
        # copies run where the step runs)
        self._in = self._out = None
        if self._cuda:
            self._in = torch.cuda.Stream(engine.device)
            self._out = torch.cuda.Stream(engine.device)

    def _wait(self, inflight: _InFlight) -> list[Frame]:
        """The dispatch's frames, once its event has passed: the stage
        "wait", which ends before the caller is handed a frame."""
        with self.tracer.stage("wait"):
            if inflight.done is not None:
                inflight.done.synchronize()
                inflight.device_tensors = ()  # every stream is done with them
            ys = inflight.y.numpy()
            us = inflight.u.numpy() if inflight.u is not None else None
            vs = inflight.v.numpy() if inflight.v is not None else None
            return [Frame(y=ys[i], u=us[i] if us is not None else None,
                          v=vs[i] if vs is not None else None)
                    for i in range(inflight.n_real)]

    def _stage(self, group: list[Frame], pool: Optional[ThreadPoolExecutor]) -> tuple:
        """The group's Y, U and V planes, each one [N, H, W] tensor on the
        engine's device (U and V None for frames without chroma). The host
        tensors are pinned on a CUDA engine and filled through their numpy
        views, so a uint16 plane is only ever copied: this thread fills one
        share of the frames and each of `pool`'s workers another."""
        planes = [[f.y for f in group]]
        if group[0].u is not None:
            planes += [[f.u for f in group], [f.v for f in group]]
        hosts = []
        for p in planes:
            first = np.asarray(p[0])
            hosts.append(torch.empty((len(p),) + first.shape, dtype=_torch_dtype(first.dtype),
                                     pin_memory=self._cuda))
        views = [h.numpy() for h in hosts]
        shares = 1 if pool is None else self._threads

        def fill(share: int) -> None:
            for i in range(share, len(group), shares):
                for view, p in zip(views, planes):
                    np.copyto(view[i], p[i])

        others = [pool.submit(fill, k) for k in range(1, shares)]
        fill(0)
        for f in others:
            f.result()
        if self._in is None:
            dev = [h.to(self.engine.device, non_blocking=True) for h in hosts]
        else:
            with torch.cuda.stream(self._in):
                dev = [h.to(self.engine.device, non_blocking=True) for h in hosts]
        return tuple(dev) if len(dev) == 3 else (dev[0], None, None)

    def _to_host(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if t is None or not self._cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if self._out is None:
            host.copy_(t, non_blocking=True)
            return host
        with torch.cuda.stream(self._out):
            host.copy_(t, non_blocking=True)
        return host

    def _dispatch_sharded(self, frame: Frame) -> _InFlight:
        """One frame through a sharded engine at batch 1: the per-plane
        entry points (`upscale_y` in row stripes) in place of the batched
        step, packed on the engine's device as `process_batch_device`
        packs them."""
        eng = self.engine

        def one(fn, t):
            if t is None:
                return None
            return pack_planes(fn(unpack_planes(t[0])), eng._out_dtype)[None]

        return self._dispatch_stack([frame], 1, lambda ys, us, vs: (
            one(eng.upscale_y, ys), one(eng.upscale_uv, us), one(eng.upscale_uv, vs)))

    def _dispatch_stack(self, group: list[Frame], pad_to: int, step=None,
                        pool: Optional[ThreadPoolExecutor] = None) -> _InFlight:
        """One device-step dispatch over a stack of frames; short tail
        groups are padded by repeating the last frame (one launch shape for
        the whole clip) and sliced when waited on. `step` is the engine's
        `process_batch_device` unless given; `pool` shares the staging
        (`_stage`). The staging and the copies in are the stage "stage"."""
        n_real = len(group)
        group = group + [group[-1]] * (pad_to - n_real)
        with self.tracer.stage("stage"):
            ys, us, vs = self._stage(group, pool)
        main = torch.cuda.current_stream(self.engine.device) if self._cuda else None
        if self._in is not None:
            main.wait_stream(self._in)  # the step starts behind its frames
        outs = (step or self.engine.process_batch_device)(ys, us, vs)
        if self._out is not None:
            self._out.wait_stream(main)  # the copies out start behind the step
        y, u, v = (self._to_host(t) for t in outs)
        if not self._cuda:
            return _InFlight(y, u, v, None, n_real)
        done = torch.cuda.Event()
        done.record(self._out if self._out is not None else main)
        return _InFlight(y, u, v, done, n_real, (ys, us, vs) + tuple(outs))

    def process(self, frames: Iterable[Frame]) -> Iterator[Frame]:
        queue: collections.deque[_InFlight] = collections.deque()
        per_frame = self.engine._mesh is not None and self.batch == 1
        group: list[Frame] = []
        pool = None
        if self._threads > 1:
            pool = ThreadPoolExecutor(self._threads - 1, thread_name_prefix="raisr-stage")
        try:
            for frame in frames:
                if per_frame:
                    with self.tracer.stage("dispatch"):
                        queue.append(self._dispatch_sharded(frame))
                else:
                    group.append(frame)
                    if len(group) < self.batch:
                        continue
                    with self.tracer.stage("dispatch"):
                        queue.append(self._dispatch_stack(group, self.batch, pool=pool))
                    group = []
                while len(queue) > self.depth:
                    yield from self._wait(queue.popleft())
            if group:
                with self.tracer.stage("dispatch"):
                    queue.append(self._dispatch_stack(group, self.batch, pool=pool))
            while queue:
                yield from self._wait(queue.popleft())
        finally:
            # a caller that stops early, or an error, leaves dispatches in
            # flight: their tensors may go back to the allocators only once
            # every stream is done with them
            for inflight in queue:
                if inflight.done is not None:
                    inflight.done.synchronize()
            if pool is not None:
                pool.shutdown()
