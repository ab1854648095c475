"""Run the port's CUDA kernel sources on the CPU, thread by thread.

    python3 tools/torch_emulate_kernels.py

Where there is no GPU and no nvcc, the kernels' plain PyTorch versions
say nothing about the CUDA sources themselves: a wrong stack index, a
backlog that overflows or a mode that dispatches to the wrong
instantiation shows only on the card. This tool compiles
platinum_tpu_torch/csrc/*.cu with g++ against a small shim of the CUDA
headers (the qualifiers as empty macros, `float2`, `float4`, `int4`,
`dim3`, `__ldg`, the bit casts, `__fmul_rn`, a nearest-even
`__float2bfloat16_rn`, thread-local `blockIdx` / `threadIdx` / `blockDim` /
`gridDim`, `__shared__` as a static, and a card of 3 SMs that holds 2 CTAs
of any kernel for the grids sized to the card), with
the L2 prefetch `asm` removed and every `<<<grid, block>>>` launch
rewritten into a call of `emu_launch`, which runs the blocks one after
another and the threads of a block as coroutines, so that
`__syncthreads`, `__syncwarp` and the warp collectives (`__ballot_sync`,
`__any_sync`, `__shfl_sync`, `__shfl_up_sync`, `__reduce_min_sync`,
`__reduce_or_sync`) act as
on the card (a barrier or collective that only part of the block or warp
reaches makes the launch report an error), and binds the result with the wrappers' own
ctypes declarations. g++ gets `-ffp-contract=fast -march=native`, so
products and sums contract to FMAs as nvcc contracts them where the host
has FMA instructions. It says nothing about registers, memory traffic or time.

As a module: `build(out_dir)` returns {source name: library path};
`Emulation(out_dir)` is a context manager in which `trace_wide`,
`trace_wide_paired`, `trace_wide_counts` and `stream_mt` of this module
and `make_bf_tracer(..., steps=BF_STEPS)` run the emulated kernels on CPU
tensors (through the wrappers' own argument checks). Run as a script it
holds every mode of wide_trace.cu and stream_mt.cu to its plain version,
and the modes that compute K1's function to K1 bit for bit, on a random
triangle soup.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from platinum_tpu_torch.ops import bfstream as bf  # noqa: E402
from platinum_tpu_torch.ops import packet_trace as pt  # noqa: E402
from platinum_tpu_torch.ops import raystream as rs  # noqa: E402

SHIM_RUNTIME = r"""
#pragma once
#include <setjmp.h>
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>
#include <math.h>
using std::max;
using std::min;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorEmulation = 2 };
// a launch whose threads broke a barrier sets it; the next
// cudaGetLastError() returns and clears it
inline int& emu_error() {
  static int e = 0;
  return e;
}
inline int cudaGetLastError() {
  const int e = emu_error();
  emu_error() = 0;
  return e;
}
inline const char* cudaGetErrorString(int c) {
  return c == 2 ? "emulated threads broke a barrier (a thread skipped "
                  "__syncthreads or a warp collective)"
                : (c ? "invalid value" : "no error");
}
// a small card: 3 SMs holding 2 CTAs of any kernel, so that each CTA of a
// grid sized to the card (a persistent kernel) takes several units
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return 0;
}
enum cudaFuncAttribute { cudaFuncAttributePreferredSharedMemoryCarveout };
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <class F>
inline int cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                         size_t) {
  *n = 2;
  return 0;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline float __uint_as_float(unsigned i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned i;
  std::memcpy(&i, &f, 4);
  return i;
}
// a rounded product that the compiler may not contract into an FMA
inline float __fmul_rn(float a, float b) {
  volatile float r = a * b;
  return r;
}
inline size_t __cvta_generic_to_global(const void* p) { return (size_t)p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
extern thread_local dim3 blockIdx, threadIdx, blockDim, gridDim;

// The threads of a block run as coroutines, one after another: a thread
// runs until it returns or reaches __syncthreads() or a warp collective,
// and the scheduler releases a barrier once every thread of the block (of
// the warp, for a collective) has reached it, computing a collective's
// results for all its lanes before any lane goes on. A barrier that some
// threads reach while others have returned or wait elsewhere, or a warp
// whose lanes reach different collectives, is a fault, as on the card: the
// block is abandoned and the launch reports an error. A thread starts on
// its own stack through ucontext and then switches with _setjmp /
// _longjmp, which save no signal mask (no system call per switch).
struct EmuThread {
  ucontext_t ctx;
  jmp_buf jb;
  bool started;
  int state;       // 0 runnable, 1 at __syncthreads, 2 at a collective, 3 done
  int op, arg;     // the collective (EmuOp) and its lane operand
  unsigned val;    // its value operand
  unsigned res;
};
enum EmuOp { kBallot, kShflUp, kShfl, kReduceMin, kReduceOr, kSyncWarp };
inline std::vector<EmuThread>& emu_threads() {
  static std::vector<EmuThread> t;
  return t;
}
inline int& emu_cur() {
  static int c = 0;
  return c;
}
inline jmp_buf& emu_sched() {
  static jmp_buf j;
  return j;
}
inline std::function<void()>& emu_body() {
  static std::function<void()> f;
  return f;
}
inline void emu_trampoline() {
  emu_body()();
  emu_threads()[emu_cur()].state = 3;
  _longjmp(emu_sched(), 1);
}
inline unsigned emu_wait(int state, int op = 0, unsigned val = 0,
                         int arg = 0) {
  EmuThread& t = emu_threads()[emu_cur()];
  t.state = state;
  t.op = op;
  t.val = val;
  t.arg = arg;
  if (!_setjmp(t.jb)) _longjmp(emu_sched(), 1);
  return emu_threads()[emu_cur()].res;
}
// run thread i until it waits or returns
__attribute__((noinline)) inline void emu_run(int i) {
  EmuThread& t = emu_threads()[i];
  if (_setjmp(emu_sched())) return;
  if (!t.started) {
    t.started = true;
    setcontext(&t.ctx);
  }
  _longjmp(t.jb, 1);
}
inline void __syncthreads() { emu_wait(1); }
// the barrier of a warp's 32 threads: a collective without a value
inline void __syncwarp(unsigned = 0xffffffffu) { emu_wait(2, kSyncWarp); }
// Warp collectives. Every lane of the warp must reach the same one (the
// kernels pass the full mask).
inline unsigned __ballot_sync(unsigned, int pred) {
  return emu_wait(2, kBallot, pred != 0);
}
inline int __any_sync(unsigned m, int pred) {
  return __ballot_sync(m, pred) != 0;
}
inline int __shfl_up_sync(unsigned, int v, int delta) {
  return (int)emu_wait(2, kShflUp, (unsigned)v, delta);
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return emu_wait(2, kShfl, v, src);
}
inline int __shfl_sync(unsigned m, int v, int src) {
  return (int)__shfl_sync(m, (unsigned)v, src);
}
inline float __shfl_sync(unsigned m, float v, int src) {
  return __uint_as_float(__shfl_sync(m, __float_as_uint(v), src));
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return emu_wait(2, kReduceMin, v);
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return emu_wait(2, kReduceOr, v);
}
// one scheduling round's barrier releases; false on a fault
inline bool emu_release(int threads, bool& released, bool& finished) {
  auto& th = emu_threads();
  released = false;
  for (int lo = 0; lo < threads; lo += 32) {
    const int hi = std::min(lo + 32, threads);
    int at = 0;
    for (int i = lo; i < hi; ++i) at += th[i].state == 2;
    if (at == 0) continue;
    if (at != hi - lo) return false;
    unsigned bits = 0, least = 0xffffffffu, any = 0u;
    for (int j = lo; j < hi; ++j) {
      if (th[j].op != th[lo].op) return false;
      bits |= (th[j].val != 0u) << (j - lo);
      least = std::min(least, th[j].val);
      any |= th[j].val;
    }
    for (int i = lo; i < hi; ++i) {
      switch (th[i].op) {
        case kBallot: th[i].res = bits; break;
        case kShflUp: {
          const int src = i - th[i].arg;
          th[i].res = src >= lo ? th[src].val : th[i].val;
          break;
        }
        case kShfl: th[i].res = th[lo + (th[i].arg & 31) % (hi - lo)].val;
          break;
        case kReduceMin: th[i].res = least; break;
        case kReduceOr: th[i].res = any; break;
        case kSyncWarp: th[i].res = 0; break;
      }
    }
    for (int i = lo; i < hi; ++i) th[i].state = 0;
    released = true;
  }
  if (released) return true;
  int done = 0, at_bar = 0;
  for (int i = 0; i < threads; ++i) {
    done += th[i].state == 3;
    at_bar += th[i].state == 1;
  }
  finished = done == threads;
  if (finished) return true;
  if (at_bar != threads) return false;
  for (int i = 0; i < threads; ++i) th[i].state = 0;
  released = true;
  return true;
}
template <class F, class... A>
void emu_launch(dim3 grid, int threads, F f, A... a) {
  constexpr size_t kStack = 1 << 16;
  static std::vector<std::vector<char>> stacks;
  if ((int)stacks.size() < threads) stacks.resize(threads);
  auto& th = emu_threads();
  th.assign(threads, EmuThread{});
  blockDim = dim3(threads);
  gridDim = grid;
  emu_body() = [&]() { f(a...); };
  for (unsigned b = 0; b < grid.x; ++b) {
    blockIdx = dim3(b);
    for (int i = 0; i < threads; ++i) {
      stacks[i].resize(kStack);
      getcontext(&th[i].ctx);
      th[i].ctx.uc_stack.ss_sp = stacks[i].data();
      th[i].ctx.uc_stack.ss_size = kStack;
      th[i].ctx.uc_link = nullptr;
      makecontext(&th[i].ctx, emu_trampoline, 0);
      th[i].started = false;
      th[i].state = 0;
    }
    for (;;) {
      for (int i = 0; i < threads; ++i)
        if (th[i].state == 0) {
          emu_cur() = i;
          threadIdx = dim3(i);
          emu_run(i);
        }
      bool released, finished = false;
      if (!emu_release(threads, released, finished)) {
        emu_error() = cudaErrorEmulation;
        return;
      }
      if (finished) break;
    }
  }
}
"""

SHIM_BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
inline __nv_bfloat16 __float2bfloat16_rn(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.v << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
"""

SOURCES = ("wide_trace", "stream_mt", "bf_stream")


def host_source(text: str) -> str:
    """A CUDA source of csrc/ as C++ for the host: the prefetch `asm`
    dropped, `kernel<...><<<grid, block, shared, stream>>>(args)` (with or
    without template arguments) turned into `emu_launch(grid, block,
    kernel<...>, args)`, and the thread indices defined."""
    text = re.sub(r"asm volatile\(.*?\);", "(void)p;", text, flags=re.S)
    text, n = re.subn(
        r"(\w+(?:<[^;()]*?>)?)\s*<<<([^,]+),\s*([^,]+),[^>]*>>>\(",
        r"emu_launch(\2, \3, \1, ", text, flags=re.S)
    if n == 0:
        raise ValueError("no kernel launch found to rewrite")
    return text.replace(
        "namespace {",
        "thread_local dim3 blockIdx, threadIdx, blockDim, gridDim;\n"
        "namespace {", 1)


def _write_headers(out_dir: str) -> str:
    """The CUDA header shims and csrc/'s shared headers in out_dir; returns
    the shim directory."""
    shim = os.path.join(out_dir, "shim")
    os.makedirs(shim, exist_ok=True)
    for name, text in (("cuda_runtime.h", SHIM_RUNTIME),
                       ("cuda_bf16.h", SHIM_BF16)):
        with open(os.path.join(shim, name), "w") as f:
            f.write(text)
    for header in pt.CSRC_SHARED:
        with open(header) as f, open(os.path.join(
                out_dir, os.path.basename(header)), "w") as g:
            g.write(f.read())
    return shim


def compile_source(name: str, text: str, out_dir: str) -> str:
    """Compile the host version of one CUDA source text with g++ into
    out_dir (whose headers `_write_headers` has written); returns the
    shared library's path. Raises where g++ refuses it."""
    cpp = os.path.join(out_dir, name + ".cpp")
    with open(cpp, "w") as f:
        f.write(host_source(text))
    lib = os.path.join(out_dir, name + "_host.so")
    proc = subprocess.run(
        ["g++", "-std=c++17", "-O2", "-ffp-contract=fast", "-march=native",
         "-U_FORTIFY_SOURCE",
         "-shared", "-fPIC", "-I", os.path.join(out_dir, "shim"), "-I",
         out_dir, "-o", lib, cpp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {name}:\n{proc.stderr[-3000:]}")
    return lib


def build(out_dir: str) -> dict:
    """Compile the host versions of csrc/*.cu into `out_dir` with g++, one
    process per source, all started together; {source name: shared
    library path}. Raises where g++ is missing or refuses a source."""
    _write_headers(out_dir)

    def one(name):
        with open(os.path.join(pt.CSRC_DIR, name + ".cu")) as f:
            return compile_source(name, f.read(), out_dir)

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(one, SOURCES)))


class _NoStream:
    cuda_stream = None


class Emulation(contextlib.AbstractContextManager):
    """Inside the context the wrappers' launch code reaches the emulated
    libraries: their library table holds them, and the two torch.cuda
    calls it makes (the device guard and the current stream) are
    stand-ins. Outside it everything is as before."""

    def __init__(self, out_dir: str):
        self.libs = build(out_dir)

    def __enter__(self):
        self._saved = (dict(pt._libs), torch.cuda.device,
                       torch.cuda.current_stream)
        for name, declare in (("wide_trace", pt._declare),
                              ("stream_mt", rs._declare),
                              ("bf_stream", bf._declare)):
            lib = ctypes.CDLL(self.libs[name])
            declare(lib)
            pt._libs[name] = lib
        torch.cuda.device = lambda dev: contextlib.nullcontext()
        torch.cuda.current_stream = lambda dev=None: _NoStream()
        return self

    def __exit__(self, *exc):
        libs, torch.cuda.device, torch.cuda.current_stream = self._saved
        pt._libs.clear()
        pt._libs.update(libs)
        return False


def split_planes(blocks):
    """`packet_trace.split_planes` through the emulated split kernel."""
    planes = torch.empty((blocks.shape[0], 2, 10, 256), dtype=torch.bfloat16)
    rc = pt._libs["wide_trace"].wide_trace_split_planes(
        blocks.data_ptr(), blocks.shape[0], planes.data_ptr(), None)
    if rc != 0:
        raise RuntimeError(f"emulated split_planes refused: {rc}")
    return planes


def trace_wide(rays, nodes, blocks, meta, any_hit, inst_feat=None,
               worder=None, mt_precision="highest", stream=False,
               pipe=False, flat_walk=False, profile="none", count=False,
               planes=None, per_thread=False):
    """`packet_trace.trace_wide` (or, with `count`, the (7, R) table of
    `trace_wide_counts(per_ray=True)`) through the emulated kernel; a
    reduced tier's closest hit reads `planes`, which it then needs;
    `per_thread` takes the mode's per-thread reference walk."""
    pt.check_mode(mt_precision, stream, pipe, flat_walk, profile)
    if per_thread:
        pt._check_per_thread(any_hit, worder, pipe or flat_walk,
                             mt_precision, inst_feat is not None)
    prec = "highest" if any_hit else mt_precision
    out = pt._launch(rays, nodes, blocks, meta, bool(any_hit), inst_feat,
                     count, worder, prec, stream,
                     pt._walk_code(meta, pipe or flat_walk, flat_walk,
                                   checked=False), profile, planes=planes,
                     per_thread=per_thread)
    if count:
        return out[5]
    return out[:5] if out[4] is not None else out[:4]


def trace_wide_paired(rays_c, rays_a, nodes, blocks, meta,
                      mt_precision="highest", stream=False, planes=None,
                      count=False, per_thread=False):
    """`packet_trace.trace_wide_paired` (or, with `count`, the two (7, R)
    tables of `trace_wide_paired_counts(per_ray=True)`) through the
    emulated kernel; `per_thread` takes K8's per-thread reference
    kernel."""
    pt.check_mode(mt_precision, stream)
    walk = pt.PER_THREAD if per_thread else 0
    nc = rays_c.shape[1]
    rays, n_split = pt.pair_rays(rays_c, rays_a)
    t, sid, u, v, _, counts = pt._launch(rays, nodes, blocks, meta, 2, None,
                                         count, None, mt_precision, stream,
                                         walk, n_split=n_split,
                                         planes=planes)
    if count:
        return pt.split_paired_counts(counts, nc, n_split, per_ray=True)
    return (t[:nc], sid[:nc], u[:nc], v[:nc]), sid[n_split:]


def stream_mt(rays, limit, pair_ray, pair_block, blocks, any_hit,
              mt_precision="highest", per_pair=False):
    """`raystream.stream_mt` through the emulated kernel (`per_pair`: the
    one-thread-per-pair reference kernel)."""
    n = pair_ray.shape[0]
    t, u, v = (torch.empty(n) for _ in range(3))
    slot = torch.empty(n, dtype=torch.int32)
    if n:
        lib = pt._libs["stream_mt"]
        entry = (lib.stream_mt_per_pair_launch if per_pair
                 else lib.stream_mt_launch)
        rc = entry(
            rays.data_ptr(), rays.shape[1], limit.data_ptr(),
            pair_ray.data_ptr(), pair_block.data_ptr(), n, blocks.data_ptr(),
            blocks.shape[0], int(bool(any_hit)), pt.PRECISIONS[mt_precision],
            t.data_ptr(), slot.data_ptr(), u.data_ptr(), v.data_ptr(), None)
        if rc != 0:
            raise RuntimeError(f"emulated stream_mt refused: {rc}")
    return t, slot, u, v


# The five steps of the breadth-first tracer through the emulated kernels
# (uncounted), for make_bf_tracer(steps=...) inside an Emulation
BF_STEPS = dict(expand=bf.expand_kernel, prefix=bf.prefix_kernel,
                emit=bf.emit_kernel, mt=bf.mt_kernel, bwd=bf.bwd_kernel)


def soup_tree(n_tris=3000, seed=0, leaf_cap=16):
    """The wide BVH of a random triangle soup (the recipe of
    tests/test_pallas_trace.py) as (nodes, blocks, meta, worder)."""
    from platinum_tpu_torch.accel.bvh import build_bvh
    from platinum_tpu_torch.accel.wide import (build_octant_orders,
                                               build_wide_bvh)

    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    v0, v1, v2 = (c + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
                  for _ in range(3))
    bvh = build_bvh(v0, v1, v2, max_leaf=4)
    o = bvh.tri_order
    geo = np.concatenate([v0[o], v1[o] - v0[o], v2[o] - v0[o],
                          np.zeros((n_tris, 3), np.float32)], -1)
    wide = build_wide_bvh(bvh, geo, leaf_cap=leaf_cap)
    return (torch.from_numpy(wide.nodes).reshape(-1, 16, 8).contiguous(),
            torch.from_numpy(wide.tri_blocks).contiguous(),
            torch.from_numpy(wide.meta).to(torch.int32).contiguous(),
            torch.from_numpy(build_octant_orders(wide.nodes)).to(torch.int32))


def soup_rays(n, seed, tmax=float("inf")):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o.T, d.T, np.full((1, n), 1e-3, np.float32),
                           np.full((1, n), tmax, np.float32)])
    return torch.from_numpy(rays).contiguous()


def same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def main():
    nodes, blocks, meta, worder = soup_tree()
    rc, ra = soup_rays(2048, 1), soup_rays(1500, 2, tmax=8.0)
    with tempfile.TemporaryDirectory() as tmp, Emulation(tmp):
        k1 = trace_wide(rc, nodes, blocks, meta, False)
        k2 = trace_wide(ra, nodes, blocks, meta, True)
        p1 = pt.trace_wide_plain(rc, nodes, blocks, meta, False)
        p2 = pt.trace_wide_plain(ra, nodes, blocks, meta, True)
        print(f"K1 vs plain: ids equal on "
              f"{(k1[1] == p1[1]).float().mean():.4%}, K2 on "
              f"{(k2[1] == p2[1]).float().mean():.4%}")
        c1 = trace_wide(rc, nodes, blocks, meta, False, count=True)
        for label, kw in (("stream", dict(stream=True)),
                          ("oct_order", dict(worder=worder)),
                          ("two_phase", dict(mt_precision="two_phase",
                                             planes=split_planes(blocks))),
                          ("pipe", dict(pipe=True)),
                          ("flat_walk", dict(flat_walk=True))):
            k = trace_wide(rc, nodes, blocks, meta, False, **kw)
            c = trace_wide(rc, nodes, blocks, meta, False, count=True, **kw)
            print(f"{label}: bit for bit K1 {same_bits(k, k1)}; pops "
                  f"{int(c[0].sum())} (K1 {int(c1[0].sum())}), MT tests "
                  f"{int(c[1].sum())} (K1 {int(c1[1].sum())})")
        (pc, pa) = trace_wide_paired(rc, ra, nodes, blocks, meta)
        print(f"paired: closest half K1 {same_bits(pc, k1)}, any-hit half "
              f"K2 {torch.equal(pa, k2[1])}")
        cnt = trace_wide(rc, nodes, blocks, meta, False, profile="count")
        fix = trace_wide(rc, nodes, blocks, meta, False, count=True,
                         profile="fix64")[0]
        print(f"profile=count: t, id K1's "
              f"{same_bits((cnt[0], cnt[1]), (k1[0], k1[1]))}, u = the "
              f"per-thread walk's pops (fix64's count up to 64) "
              f"{torch.equal(cnt[2].int().clamp(max=64), fix)}: "
              f"{int(cnt[2].sum())} (K1's warp-wide walk {int(c1[0].sum())})")
        pair = rs.make_stream_tracer(nodes.reshape(-1, 128), blocks, meta,
                                     mt_fn=stream_mt)
        rec = pair[0](rc[0:3].T.contiguous(), rc[3:6].T.contiguous(), 1e-3,
                      float("inf"))
        hit = k1[1] >= 0
        print(f"ray-stream tracer vs K1: hits {torch.equal(rec.hit, hit)}, "
              f"t bits {torch.equal(rec.t[hit], k1[0][hit])}, ids "
              f"{torch.equal(rec.tri[hit], k1[1][hit])}")


if __name__ == "__main__":
    main()
