"""How the port's wrappers reach their kernels, and fp32 attention at long
sequences, on the CPU.

``build.launch`` is the one door to a kernel: it runs the C entry point
with the tensors' device current (so a launch, and each
``cudaFuncSetAttribute`` before it, lands on the device the data lies on)
and with that device's stream, sets each function's ``ctypes`` signature
once, and raises with the library's error string. A fake library and a
patched ``torch.cuda`` stand in for the card. An AST check holds every
wrapper under ``custom_yolo_tpu_torch/ops/`` to that door. The NMS
wrappers hand a pool of K = 10240 to the kernels instead of refusing it,
as they did while the kernels held per-K state in shared memory; the SPPF
wrapper hands a 4K frame's p5 map to its kernel, which works on tiles,
where it refused maps whose two copies did not fit in shared memory; the
grouped stochastic rounding builds one table of leaves and launches once.
Then the
fp32 attention twins, forward and backward, against the JAX package at
T = 900 and T = 1600, the sequence lengths the fp32 kernels refused before
they streamed their key tiles.
"""

import ast
import contextlib
import ctypes
import threading
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.ops.pallas.attention_kernel import (
    _psa_attention_bwd_pallas, psa_attention_pallas,
    psa_attention_reference as jax_attention_reference)
from custom_yolo_tpu_torch.ops import (attention, nms_kernel, quant_kernel,
                                       sppf_kernel)
from custom_yolo_tpu_torch.ops.cuda import build

torch.set_num_threads(2)

OPS = Path(__file__).resolve().parents[1] / "custom_yolo_tpu_torch" / "ops"


# ------------------------------------------------------------ build.launch
class FakeFunction:
    """A C function of a fake library: records its calls, the device that
    was current at each, and every assignment to its signature."""

    def __init__(self, lib, result):
        self.__dict__.update(lib=lib, result=result, calls=[], sets=[])

    def __setattr__(self, key, value):
        self.sets.append(key)
        self.__dict__[key] = value

    def __call__(self, *args):
        self.calls.append((args, self.lib.current[-1]
                           if self.lib.current else None))
        return self.result(args) if callable(self.result) else self.result


class FakeLibrary:
    def __init__(self, status: int):
        self.current = []
        self.kernel_fn = FakeFunction(self, status)
        self.cuda_error_string = FakeFunction(
            self, lambda args: f"fake error {args[0]}".encode())


@pytest.fixture()
def fake_cuda(monkeypatch):
    """``torch.cuda.device`` and ``current_stream`` that record what they
    were given; the library's ``current`` stack is the current device."""
    streams = []
    monkeypatch.setattr(build, "_functions", {})
    state = types.SimpleNamespace(lib=None, streams=streams)

    @contextlib.contextmanager
    def device(dev):
        state.lib.current.append(torch.device(dev))
        try:
            yield
        finally:
            state.lib.current.pop()

    def current_stream(dev=None):
        streams.append((torch.device(dev), state.lib.current[-1]
                        if state.lib.current else None))
        return types.SimpleNamespace(cuda_stream=4000 + (torch.device(
            dev).index or 0))

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return state


def test_load_builds_a_library_once_across_threads(monkeypatch):
    """Threads that serve replicas reach a library's first use at once:
    one builds and loads it, the others wait for it and take the same
    handle."""
    built = []

    def slow_build(names):
        built.append(list(names))
        time.sleep(0.05)

    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    start, libs = threading.Barrier(4), []

    def work():
        start.wait(timeout=60)
        libs.append(build.load("sppf"))

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert built == [["sppf"]]
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)


def test_launch_runs_on_the_tensor_device_with_its_stream(fake_cuda):
    lib = fake_cuda.lib = FakeLibrary(status=0)
    dev = torch.device("cuda", 1)
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    build.launch(lib, "kernel_fn", argtypes, (123, 7), dev)
    # called once, with the stream appended, while cuda:1 was current
    assert lib.kernel_fn.calls == [((123, 7, 4001), dev)]
    assert fake_cuda.streams == [(dev, dev)]
    assert lib.kernel_fn.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
    assert lib.kernel_fn.restype is ctypes.c_int
    assert lib.current == []           # the guard is left again


def test_launch_sets_the_signature_once(fake_cuda):
    lib = fake_cuda.lib = FakeLibrary(status=0)
    for index in (0, 1, 0):
        build.launch(lib, "kernel_fn", [ctypes.c_int], (index,),
                     torch.device("cuda", index))
    assert sorted(lib.kernel_fn.sets) == ["argtypes", "restype"]
    assert [dev for _, dev in lib.kernel_fn.calls] == [
        torch.device("cuda", i) for i in (0, 1, 0)]
    assert build.query(lib, "kernel_fn", [ctypes.c_int], ctypes.c_int, 5) \
        == 0
    assert sorted(lib.kernel_fn.sets) == ["argtypes", "restype"]


def test_launch_raises_with_the_library_error_string(fake_cuda):
    lib = fake_cuda.lib = FakeLibrary(status=98)
    with pytest.raises(RuntimeError,
                       match=r"cls_stage launch: CUDA error 98 \(fake error "
                             r"98\)"):
        build.launch(lib, "kernel_fn", [], (), torch.device("cuda", 0),
                     "cls_stage launch")
    # the default names the function
    with pytest.raises(RuntimeError, match="kernel_fn launch: CUDA error"):
        build.launch(lib, "kernel_fn", [], (), torch.device("cuda", 0))
    assert lib.cuda_error_string.argtypes == [ctypes.c_int]
    assert lib.cuda_error_string.restype is ctypes.c_char_p
    assert lib.current == []


# ------------------------------------------------------ one door, checked
def _is_build_call(node, names) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "build" and node.func.attr in names)


def test_wrappers_reach_c_only_through_build_launch():
    """No module under ops/ touches a loaded library except as the first
    argument of ``build.launch`` (kernels) or ``build.query`` (host-side
    sizes), nor sets a ctypes signature itself; each C entry point that
    launches a kernel is named in a ``build.launch``."""
    launched = set()
    for path in sorted(OPS.glob("*.py")):
        tree = ast.parse(path.read_text())
        parents = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        libs = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("argtypes", "restype"), (
                    f"{path.name}:{node.lineno} sets a ctypes signature")
            if _is_build_call(node, ("load",)):
                parent = parents[node]
                if isinstance(parent, ast.Assign):
                    assert [type(t) for t in parent.targets] == [ast.Name], (
                        f"{path.name}:{node.lineno}")
                    libs.add(parent.targets[0].id)
                else:
                    assert _is_build_call(parent, ("launch", "query")) \
                        and parent.args[0] is node, (
                            f"{path.name}:{node.lineno}: a library used "
                            "outside build.launch/build.query")
            if _is_build_call(node, ("launch",)):
                assert isinstance(node.args[1], ast.Constant), (
                    f"{path.name}:{node.lineno}")
                launched.add((path.name, node.args[1].value))
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and node.id in libs \
                    and isinstance(node.ctx, ast.Load):
                parent = parents[node]
                assert _is_build_call(parent, ("launch", "query")) \
                    and parent.args[0] is node, (
                        f"{path.name}:{node.lineno}: library {node.id!r} "
                        "used outside build.launch/build.query")
    assert launched == {
        ("attention.py", "psa_attention_fwd"),
        ("attention.py", "psa_attention_bwd"),
        ("nms_kernel.py", "nms_keep_bitmask"),
        ("sppf_kernel.py", "sppf_pyramid"),
        ("head_kernel.py", "cls_stage"),
        ("quant_kernel.py", "stochastic_round_int8_grouped"),
    }


# ------------------------------------------------ NMS pools of any size
@pytest.mark.parametrize("wrapper,n", [("nms_keep_batched", 2),
                                       ("nms_keep_single", 1)])
def test_nms_wrappers_pass_any_pool_size_to_the_kernel(fake_cuda,
                                                       monkeypatch, wrapper,
                                                       n):
    """K = 10240 (the x preset's 8400 anchors with multi-label candidates
    and ``top_k=10000`` rounds past it) reaches ``nms_keep_bitmask`` with
    a scratch of the bit matrix, its diagonal's column words and the
    removed words, and is counted. The op's CUDA implementation is called
    directly (a meta tensor dispatches to the op's fake implementation):
    meta tensors stand in for CUDA ones, and only the device test of its
    check is patched."""
    lib = fake_cuda.lib = FakeLibrary(status=0)
    lib.nms_keep_bitmask = FakeFunction(lib, 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(nms_kernel, "_on_one_cuda_device",
                        lambda b, v: b.device == v.device)
    scratch = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: scratch.append(
        (a, kw.get("dtype"))) or empty(*a, **kw))
    fn = getattr(nms_kernel, wrapper)
    monkeypatch.setattr(fn, "launches", 0)
    k, words = 10240, 160
    boxes = empty(n, k, 4, device="meta")
    valid = empty(n, k, dtype=torch.bool, device="meta")
    keep = getattr(nms_kernel, f"_{wrapper}_cuda")(boxes, valid, 0.45)
    assert keep.shape == (n, k) and keep.dtype == torch.bool
    [(args, dev)] = lib.nms_keep_bitmask.calls
    assert args[4:] == (n, k, 0.45, nms_kernel.SHARED_REMOVED_WORDS, 4000)
    assert dev == torch.device("meta")
    assert scratch[-1] == ((n * (words * (k + 1) + k),), torch.int64)
    assert fn.launches == 1
    # the typed argument list: four pointers, n, k, the fp32 threshold,
    # the shared-memory limit and the stream
    assert lib.nms_keep_bitmask.argtypes == [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


# ----------------------------------------------- SPPF maps of any size
@pytest.mark.parametrize("shape,dtype", [
    ((1, 384, 68, 120), torch.bfloat16),    # x at 2176 × 3840, p5 map
    ((1, 64, 62, 62), torch.float32),       # past 3,632 fp32 pixels
], ids=["bf16-4k", "fp32-62x62"])
def test_sppf_wrapper_passes_any_map_size_to_the_kernel(fake_cuda,
                                                        monkeypatch, shape,
                                                        dtype):
    """Maps whose two copies exceeded a block's shared memory (the old
    kernel's limit, 2·H·W·size·8 > 232,448 bytes) reach ``sppf_pyramid``
    as tiles of at most 16 × 16 pixels within 48 KB, and are counted. The
    op's CUDA implementation is called directly: meta tensors stand in for
    CUDA ones; only its device test and its reading of the card's SM count
    are patched."""
    lib = fake_cuda.lib = FakeLibrary(status=0)
    lib.sppf_pyramid = FakeFunction(lib, 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(sppf_kernel, "_on_cuda", lambda x: True)
    monkeypatch.setattr(sppf_kernel, "_sm_count", lambda device: 132)
    monkeypatch.setattr(sppf_kernel.sppf_pyramid, "launches", 0)
    b, c, h, w = shape
    x = torch.empty(shape, dtype=dtype, device="meta",
                    memory_format=torch.channels_last)
    out = sppf_kernel._sppf_pyramid_cuda(x)
    assert out.shape == (b, 4 * c, h, w) and out.dtype == dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    [(args, dev)] = lib.sppf_pyramid.calls
    assert dev == torch.device("meta") and sppf_kernel.sppf_pyramid.launches == 1
    nb, nh, nw, nv, size, vec, th, tw, cvb, stream = args[2:]
    assert (nb, nh, nw, size, stream) == (b, h, w, x.element_size(), 4000)
    assert vec * size == 16 and nv * vec == c          # 16-byte vectors
    assert 1 <= th <= 16 and 1 <= tw <= 16 and cvb >= 1
    # three row maxima of the tile and a halo of 6 rows, in 48 KB
    assert 3 * (th + 12) * tw * cvb * 16 <= 48 * 1024
    assert lib.sppf_pyramid.argtypes == [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 9 + [ctypes.c_void_p]


@pytest.mark.parametrize("b,c,h,w,size,sms,vec,blocks", [
    (8, 384, 20, 20, 2, 132, 8, 384),   # the x serve shape on an H100
    (1, 384, 20, 20, 2, 132, 8, 192),   # one image still spreads
    (8, 384, 20, 20, 4, 132, 4, 768),
    (2, 5, 13, 7, 2, 132, 1, 10),       # odd C: one bf16 channel a thread
    (2, 6, 9, 11, 2, 132, 1, 12),
    (1, 6, 9, 11, 4, 132, 1, 6),
    (1, 384, 20, 20, 2, 16, 8, 48),     # a card of 16 SMs: wider chunks
])
def test_sppf_launch_shape_spreads_over_the_card(b, c, h, w, size, sms, vec,
                                                 blocks):
    """The vector width follows C, tiles split the map evenly, and the
    blocks reach the SMs: at least two for each of the card's SMs where the
    map allows, the most otherwise."""
    got_vec, th, tw, cvb = sppf_kernel.launch_shape(b, c, h, w, size, sms,
                                                    0, 0)
    assert got_vec == vec
    tiles = -(-h // th) * -(-w // tw)
    assert -(-h // th) * th - h < -(-h // th) and th <= 16 and tw <= 16
    assert b * tiles * -(-(c // vec) // cvb) == blocks
    # a tensor one element past a 16-byte boundary takes one at a time
    assert sppf_kernel.launch_shape(b, c, h, w, size, sms, size,
                                    0)[0] == 1


# ------------------------------------- grouped stochastic rounding (K7)
def test_grouped_stochastic_round_builds_one_table_and_launches_once(
        fake_cuda, monkeypatch):
    """Leaves of odd sizes (and an empty one) go to
    ``stochastic_round_int8_grouped`` in one launch with one table row
    each: addresses, elements and the first block, ⌈n / 2048⌉ blocks a
    leaf. Meta tensors stand in for CUDA ones."""
    lib = fake_cuda.lib = FakeLibrary(status=0)
    lib.stochastic_round_int8_grouped = FakeFunction(lib, 0)
    monkeypatch.setattr(build, "load", lambda name: lib)
    monkeypatch.setattr(quant_kernel, "_on_one_cuda_device",
                        lambda flats, dev: True)
    monkeypatch.setattr(quant_kernel.stochastic_round_many, "launches", 0)
    sizes = (1, 3, 0, 1023, 1025, 6912 * 7)
    flats = [torch.empty(n, device="meta") for n in sizes]
    outs = quant_kernel.stochastic_round_many(flats, 2 ** 40 + 7)
    assert [o.shape for o in outs] == [f.shape for f in flats]
    assert all(o.dtype == torch.int8 for o in outs)
    [(args, dev)] = lib.stochastic_round_int8_grouped.calls
    assert quant_kernel.BLOCK_ELEMS == 2048
    blocks = [-(-n // 2048) for n in sizes if n]
    assert args[1:] == (5, sum(blocks), 2048, 7, 2 ** 8, 4000)
    assert dev == torch.device("meta")
    assert quant_kernel.stochastic_round_many.launches == 1
    assert lib.stochastic_round_int8_grouped.argtypes == [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
    # the rows, with real addresses
    cpu = [torch.zeros(n) for n in sizes]
    cpu_out = [torch.empty(n, dtype=torch.int8) for n in sizes]
    rows, total = quant_kernel.leaf_table(cpu, cpu_out)
    firsts = np.cumsum([0] + blocks[:-1]).tolist()
    assert rows == [(f.data_ptr(), o.data_ptr(), f.numel(), first)
                    for (f, o), first in zip(
                        [(f, o) for f, o in zip(cpu, cpu_out) if f.numel()],
                        firsts)]
    assert total == sum(blocks)


# ---------------------------------------------- fp32 attention at long T
def _qkv(shape, seed):
    b, t, nh, dk, dh = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, nh * (2 * dk + dh)).astype(np.float32),
            rng.randn(b, t, nh * dh).astype(np.float32),
            rng.randn(b, t, nh * dh).astype(np.float32))


@pytest.mark.parametrize("t", [900, 1600])
def test_fp32_attention_twin_matches_jax_at_long_t(t):
    """out within 1e-5 and v exact against the Pallas kernel (interpret
    mode) and the einsum reference, as at short T."""
    nh, dk, dh = 2, 32, 64
    qkv_np, _, _ = _qkv((1, t, nh, dk, dh), seed=t)
    out_t, v_t = attention.psa_attention(torch.from_numpy(qkv_np), nh, dk,
                                         dh)
    qkv_j = jnp.asarray(qkv_np)
    for fn in (lambda q: psa_attention_pallas(q, nh, dk, dh, interpret=True),
               lambda q: jax_attention_reference(q, nh, dk, dh)):
        out_j, v_j = fn(qkv_j)
        np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   atol=1e-5, rtol=1e-5)
    assert attention.psa_attention.launches == 0


@pytest.mark.parametrize("t", [900, 1600])
def test_fp32_attention_bwd_twin_matches_jax_at_long_t(t):
    """dqkv within 1e-5 of the Pallas backward kernel (interpret mode) and
    1e-4 of autodiff through the einsum reference, as at short T."""
    nh, dk, dh = 2, 32, 64
    arrays = _qkv((1, t, nh, dk, dh), seed=t + 1)
    got = attention.psa_attention_bwd(*(torch.from_numpy(a) for a in arrays),
                                      nh, dk, dh).numpy()
    qkv_j, do_j, dv_j = (jnp.asarray(a) for a in arrays)
    want = _psa_attention_bwd_pallas(qkv_j, do_j, dv_j, nh, dk, dh,
                                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    _, vjp = jax.vjp(lambda x: jax_attention_reference(x, nh, dk, dh), qkv_j)
    np.testing.assert_allclose(got, np.asarray(vjp((do_j, dv_j))[0]),
                               atol=1e-4, rtol=1e-4)
    assert attention.psa_attention_bwd.launches == 0
