"""The port's StreamProcessor on the CPU: the cases of tests/test_stream.py
against the port on a generated bank, and the port's streamed frames against
raisr_tpu's StreamProcessor on the same bank folder and clip.

Against raisr_tpu both engines run taps (backend="reference"): U and V must
be exact; Y is held to the cross-backend bar (under 2% of pixels differ,
median 0). Y is not exact: on these noise frames about 0.2% of the pixels
differ (raisr_tpu runs the step as one jitted computation, which XLA fuses
and contracts differently from PyTorch's op-by-op float32, and a hash
near a bin edge then picks another filter), so the test pins the bar, not 0.
"""

import threading

import numpy as np
import pytest

pytest.importorskip("torch")  # CI's test job installs no torch

import raisr_tpu.config as jcfg
import raisr_tpu.engine as jengine
import raisr_tpu.stream as jstream
from raisr_tpu_torch import RaisrConfig, RaisrEngine, load_model
from raisr_tpu_torch.engine import Frame
from raisr_tpu_torch.stream import StreamProcessor
from raisr_tpu_torch.utils.profiler import Tracer
from torch_port_util import frac_and_median, write_bank_and_clip

FUZZ_FRAC = 0.02


def _frames(n, h, w, seed, bits=8, mono=False):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits == 8 else np.uint16
    lo, hi = (16, 235) if bits == 8 else (64, 940)
    out = []
    for _ in range(n):
        y = rng.integers(lo, hi, (h, w)).astype(dt)
        if mono:
            out.append(Frame(y=y))
        else:
            out.append(Frame(y=y, u=rng.integers(lo, hi, (h // 2, w // 2)).astype(dt),
                             v=rng.integers(lo, hi, (h // 2, w // 2)).astype(dt)))
    return out


def _same(a: Frame, b: Frame) -> bool:
    return all(
        (p is None and q is None) or (p.dtype == q.dtype and np.array_equal(p, q))
        for p, q in ((a.y, b.y), (a.u, b.u), (a.v, b.v)))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_bank_and_clip(tmp_path_factory.mktemp("stream"), n_frames=1, seed=3)[0]


def _engine(folder, **kw):
    cfg = RaisrConfig(filterfolder=folder, **kw)
    return RaisrEngine(cfg, load_model(folder, cfg), device="cpu")


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_stream_matches_sync(folder, backend):
    engine = _engine(folder, backend=backend)
    frames = _frames(5, 24, 32, 0)
    sync = [engine.process(f) for f in frames]
    streamed = list(StreamProcessor(engine, depth=3).process(iter(frames)))
    assert len(streamed) == 5
    assert all(_same(a, b) for a, b in zip(streamed, sync))


@pytest.mark.parametrize("passes,mode", [(1, 1), (2, 1), (2, 2)])
def test_batched_stream_identical_to_single(folder, passes, mode):
    """StreamProcessor(batch=N) must yield exactly the single-frame outputs
    (guard-banded stack + per-frame zone masks), including a short tail."""
    engine = _engine(folder, passes=passes, mode=mode, backend="pallas")
    frames = _frames(5, 40, 64, 17)
    single = list(StreamProcessor(engine, depth=1).process(iter(frames)))
    batched = list(StreamProcessor(engine, depth=1, batch=3).process(iter(frames)))
    assert len(batched) == len(single) == 5
    assert all(_same(s, b) for s, b in zip(single, batched))
    sync = [engine.process(f) for f in frames]
    assert all(_same(s, b) for s, b in zip(sync, batched))


@pytest.mark.parametrize("depth,batch,n", [(1, 1, 1), (2, 4, 3), (4, 2, 7), (2, 2, 0),
                                             (2, 6, 9)])
def test_depth_batch_and_count(folder, depth, batch, n):
    """Any depth and batch, clips shorter than a group or than the queue,
    and an empty clip: the frames come out in order, none lost or doubled."""
    engine = _engine(folder)
    frames = _frames(n, 16, 24, 100 + n)
    tracer = Tracer()
    out = list(StreamProcessor(engine, depth=depth, batch=batch, tracer=tracer)
               .process(iter(frames)))
    assert len(out) == n
    assert all(_same(a, engine.process(f)) for a, f in zip(out, frames))
    groups = -(-n // batch)
    counts = {k: s.count for k, s in tracer.stages.items()}
    assert counts == (dict.fromkeys(("dispatch", "stage", "wait"), groups) if n else {})


def test_mono_frames(folder):
    engine = _engine(folder, backend="pallas")
    frames = _frames(4, 24, 32, 5, mono=True)
    out = list(StreamProcessor(engine, depth=2, batch=3).process(iter(frames)))
    assert len(out) == 4 and all(f.u is None and f.v is None for f in out)
    assert all(_same(a, engine.process(f)) for a, f in zip(out, frames))


@pytest.mark.parametrize("bits", [10, 16])
def test_high_bit_frames(tmp_path, bits):
    """uint16 frames are staged and read back as they are."""
    folder = write_bank_and_clip(tmp_path, n_frames=1, seed=4, bits=bits)[0]
    engine = _engine(folder, bits=bits, backend="pallas")
    frames = _frames(3, 24, 32, 6, bits=10)
    out = list(StreamProcessor(engine, depth=2, batch=2).process(iter(frames)))
    assert all(f.y.dtype == np.uint16 and f.u.dtype == np.uint16 for f in out)
    assert all(_same(a, engine.process(f)) for a, f in zip(out, frames))


def test_outputs_survive_later_dispatches(folder):
    """A frame handed out is not overwritten by a later dispatch: keep every
    output of a long clip of distinct frames, then compare."""
    engine = _engine(folder)
    frames = _frames(12, 16, 24, 9)
    kept = []
    for f in StreamProcessor(engine, depth=1, batch=2).process(iter(frames)):
        kept.append(f)
    assert all(_same(a, engine.process(f)) for a, f in zip(kept, frames))


@pytest.mark.parametrize("bits,batch", [(8, 1), (8, 3), (10, 2)])
def test_stream_matches_jax_stream(tmp_path, bits, batch):
    folder = write_bank_and_clip(tmp_path, n_frames=1, seed=5, bits=bits)[0]
    frames = _frames(5, 24, 32, 11, bits=bits)
    kw = dict(filterfolder=folder, passes=2, bits=bits, backend="reference")
    port = list(StreamProcessor(_engine(folder, passes=2, bits=bits, backend="reference"),
                                depth=2, batch=batch).process(iter(frames)))
    jeng = jengine.RaisrEngine(jcfg.RaisrConfig(**kw))
    jframes = [jengine.Frame(y=f.y, u=f.u, v=f.v) for f in frames]
    jax_out = list(jstream.StreamProcessor(jeng, depth=2, batch=batch).process(iter(jframes)))
    assert len(port) == len(jax_out) == 5
    for a, b in zip(port, jax_out):
        assert a.y.dtype == b.y.dtype and a.y.shape == b.y.shape
        assert np.array_equal(a.u, b.u) and np.array_equal(a.v, b.v)
        frac, med = frac_and_median(a.y, b.y)
        assert frac < FUZZ_FRAC and med == 0.0, (frac, med)


def test_consumer_may_stop_early(folder):
    """Abandoning the generator with dispatches in flight is clean, and the
    processor can be used again."""
    engine = _engine(folder)
    frames = _frames(8, 16, 24, 13)
    sp = StreamProcessor(engine, depth=2, batch=2)
    gen = sp.process(iter(frames))
    first = next(gen)
    gen.close()
    assert _same(first, engine.process(frames[0]))
    again = list(sp.process(iter(frames)))
    assert all(_same(a, engine.process(f)) for a, f in zip(again, frames))


@pytest.mark.parametrize("stop_early", [False, True])
def test_stage_threads_end_with_the_call(folder, stop_early):
    """The threads that share a group's staging live as long as one process
    call, whether the caller drains the stream or stops early."""
    engine = _engine(folder)
    frames = _frames(6, 16, 24, 17)
    gen = StreamProcessor(engine, depth=2, batch=3).process(iter(frames))
    if stop_early:
        next(gen)
        gen.close()
    else:
        out = list(gen)
        assert all(_same(a, engine.process(f)) for a, f in zip(out, frames))
    assert not [t for t in threading.enumerate() if t.name.startswith("raisr-stage")]
