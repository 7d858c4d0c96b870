"""The port's two hand-written CUDA kernels, their wrappers, plain versions
and launch counters.

  capacity_fit       csrc/capacity_fit.cu — replaces the TPU kernel
                     kubernetes_tpu/ops/pallas_kernels.py:90
                     capacity_fits_pallas (the PodFitsResources mask).
  incidence_matmul   csrc/incidence_matmul.cu — replaces
                     kubernetes_tpu/ops/pallas_kernels.py:144
                     incidence_matmul_pallas (the affinity incidence
                     product behind precompute_static): int8 tensor cores
                     over byte planes of A, launched by the plan of
                     incidence_plan.

Each wrapper dispatches on the device of the tensors it is given: on a
CUDA tensor it launches its kernel on the current stream (and raises if
the launch fails); on a CPU tensor it runs the plain PyTorch version
beside it. There is no fallback from one to the other. The sources are
compiled at first use with nvcc (sm_90a, a plain C interface, loaded
with ctypes) into ``.torch_kernels/`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

from kubernetes_tpu_torch.state.snapshot import (
    NUM_BASE_RESOURCES,
    R_OVERLAY,
    R_SCRATCH,
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# shared memory per capacity block is 4 * R * (16 + 2 * 128) bytes, which
# must stay under the 48 KB a block gets without opting in
CAPACITY_MAX_R = 40
# returned by a launch function for a plan it cannot run (never a
# cudaError_t, which are all >= 0)
BAD_PLAN = -1

# name -> (source file, exported C function, ctypes argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNELS = {
    "capacity_fit": ("capacity_fit.cu", "capacity_fit_launch",
                     (_P, _P, _P, _P, _I, _I, _I, _P)),
    "incidence_matmul": ("incidence_matmul.cu", "incidence_matmul_launch",
                         (_P, _P, _P, _P, _P) + (_I,) * 7 + (_P,)),
}

# launches of each kernel since the last reset_launch_counts(); only the
# CUDA branch of a wrapper counts, right where it launches
LAUNCHES: Dict[str, int] = {name: 0 for name in _KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    src = _CSRC / _KERNELS[name][0]
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=tuple(_KERNELS)) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one nvcc process
    per source, all started together. Returns {name: ptxas report} for the
    sources compiled by this call. Raises RuntimeError naming the source
    when nvcc fails."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / _KERNELS[name][0])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{_KERNELS[name][0]}"
                                   f" (exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            reports[name] = log
        return reports


def _lib(name: str):
    fn = _libs.get(name)
    if fn is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, _KERNELS[name][1])
        fn.argtypes = list(_KERNELS[name][2])
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return fn


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d tensor, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _raise_on(code: int, name: str) -> None:
    if code == BAD_PLAN:
        raise RuntimeError(f"{name}: the kernel refused its launch plan")
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {code}")


# ---------------------------------------------------------------------------
# capacity_fit
# ---------------------------------------------------------------------------


def capacity_fit_plain(pod_req: torch.Tensor, alloc: torch.Tensor,
                       requested: torch.Tensor) -> torch.Tensor:
    """The plain version: PodFitsResources (predicates.go:556-624) without
    the pod-count check and without the zero-request override, as the
    broadcast compare over a [P, N, R] cube. int32 in, bool [P, N] out.
    Column layout: 0=cpu 1=mem 2=gpu 3=scratch 4=overlay 5..=extended."""
    total = pod_req[:, None, :] + requested[None, :, :]          # [P,N,R]
    ok = total <= alloc[None, :, :]
    plain = torch.cat([ok[..., :R_SCRATCH], ok[..., NUM_BASE_RESOURCES:]],
                      dim=-1).all(dim=-1)
    # storage special-case (predicates.go:590-604): when the node reports no
    # overlay capacity, overlay requests fall back onto scratch space
    alloc_s = alloc[None, :, R_SCRATCH]
    alloc_o = alloc[None, :, R_OVERLAY]
    pod_s = pod_req[:, None, R_SCRATCH]
    pod_o = pod_req[:, None, R_OVERLAY]
    node_s = requested[None, :, R_SCRATCH]
    node_o = requested[None, :, R_OVERLAY]
    no_overlay = alloc_o == 0
    scratch_ok = torch.where(no_overlay,
                             pod_s + pod_o + node_s + node_o <= alloc_s,
                             pod_s + node_s <= alloc_s)
    overlay_ok = no_overlay | (pod_o + node_o <= alloc_o)
    return plain & scratch_ok & overlay_ok


def capacity_fit(pod_req: torch.Tensor, alloc: torch.Tensor,
                 requested: torch.Tensor) -> torch.Tensor:
    """The resource-fit mask [P, N] bool (zero-request override excluded):
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if pod_req.device.type == "cpu":
        return capacity_fit_plain(pod_req, alloc, requested)
    dev = pod_req.device
    for nm, t in (("pod_req", pod_req), ("alloc", alloc),
                  ("requested", requested)):
        _check_cuda(f"capacity_fit {nm}", t, torch.int32, 2, dev)
    p, r = pod_req.shape
    n = alloc.shape[0]
    if alloc.shape[1] != r or tuple(requested.shape) != (n, r):
        raise ValueError(f"capacity_fit: shapes {tuple(pod_req.shape)}, "
                         f"{tuple(alloc.shape)}, {tuple(requested.shape)}")
    if not NUM_BASE_RESOURCES <= r <= CAPACITY_MAX_R:
        raise ValueError(f"capacity_fit: {r} resource columns, the kernel "
                         f"takes {NUM_BASE_RESOURCES}..{CAPACITY_MAX_R}")
    out = torch.empty((p, n), dtype=torch.bool, device=dev)
    if p == 0 or n == 0:
        return out
    fn = _lib("capacity_fit")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(pod_req.data_ptr(), alloc.data_ptr(), requested.data_ptr(),
                  out.data_ptr(), p, n, r, stream)
    _raise_on(code, "capacity_fit")
    LAUNCHES["capacity_fit"] += 1
    return out


# ---------------------------------------------------------------------------
# incidence_matmul
# ---------------------------------------------------------------------------

INCIDENCE_TILE_N = 128   # output columns per block (kTileN in the source)
INCIDENCE_PLANES = 4     # signed base-256 digits of an int32
INCIDENCE_PREPASS_CHUNK = 1024   # entries of L per pre-pass block
INCIDENCE_BLOCK_K = 128  # bytes of L per pipeline stage (kBlockK)
# main-kernel blocks resident on one SM, for every tile height: the source
# holds each configuration to it (launch bounds, shared-memory assert)
INCIDENCE_BLOCKS_PER_SM = 2


def incidence_plan(m: int, n: int, l: int, sms: int = 132) -> dict:
    """The launch plan of the incidence kernel for A [m, l] x B_t [n, l]
    on a card with `sms` SMs (one wave = INCIDENCE_BLOCKS_PER_SM * sms
    blocks):

      tile_m        output rows per block: 16 up to 16 rows (the
                    verdict's one class is one tile), else 128;
      block_k       bytes of L per pipeline stage, fixed by the source;
      split         slices of the L axis, one per gridDim.z: when the
                    (M, N) grid leaves part of a wave empty, as many as
                    fill it (at most one per block_k step); each slice
                    adds into the zeroed output;
      kb_per_split  block_k steps in each slice (the last may be shorter);
      l_pad         L rounded up to block_k: the row length of the planes;
      chunks        pre-pass blocks per row of A (1,024 entries each);
      grid          (x, y, z) = (N tiles, M tiles, split).

    `l` must be a multiple of 8 (the wrapper pads it so)."""
    if m <= 0 or n <= 0 or l <= 0:
        raise ValueError(f"incidence_plan: empty product {m} x {n} x {l}")
    if l % 8:
        raise ValueError(f"incidence_plan: L = {l} is not a multiple of 8")
    gx = -(-n // INCIDENCE_TILE_N)
    tile_m = 16 if m <= 16 else 128
    block_k = INCIDENCE_BLOCK_K
    gy = -(-m // tile_m)
    nkb = -(-l // block_k)
    wave = INCIDENCE_BLOCKS_PER_SM * sms
    split = max(1, min(nkb, wave // (gx * gy)))
    kb_per_split = -(-nkb // split)
    split = -(-nkb // kb_per_split)      # no empty slice
    l_pad = nkb * block_k
    return {"tile_m": tile_m, "tile_n": INCIDENCE_TILE_N,
            "block_k": block_k, "split": split,
            "kb_per_split": kb_per_split, "l_pad": l_pad,
            "chunks": -(-l_pad // INCIDENCE_PREPASS_CHUNK),
            "grid": (gx, gy, split)}


def incidence_planes_plain(a: torch.Tensor, l_pad: int):
    """The plain version of the kernel's pre-pass: A int32 [M, L] as four
    int8 planes [4, M, l_pad] of signed base-256 digits, a = s0 + 2^8 s1
    + 2^16 s2 + 2^24 s3 (mod 2^32), each s in [-128, 127], zero past L;
    and each row's digit count int32 [M]: 0 for a zero row, else one more
    than the highest digit the row's entries need."""
    m, l = a.shape
    r = a.to(torch.int64) & 0xFFFFFFFF               # the uint32 bits
    planes = torch.zeros((INCIDENCE_PLANES, m, l_pad), dtype=torch.int8,
                         device=a.device)
    need = torch.zeros((m, l), dtype=torch.int32, device=a.device)
    for p in range(INCIDENCE_PLANES):
        d = ((r & 0xFF) ^ 0x80) - 0x80               # the low byte, signed
        planes[p, :, :l] = d.to(torch.int8)
        need = torch.where(r != 0, p + 1, need)
        q = (r - d) & 0xFFFFFFFF                     # a multiple of 256
        q = q - ((q >> 31) << 32)                    # as int32
        r = (q >> 8) & 0xFFFFFFFF
    count = need.amax(dim=1) if l else need.new_zeros(m)
    return planes, count.to(torch.int32)


def incidence_matmul_plain(a: torch.Tensor, b_t: torch.Tensor
                           ) -> torch.Tensor:
    """The plain version: A [M, L] x B_t [N, L] -> int32 [M, N], as a
    float64 product of the integer operands. Exact while every |partial
    sum| < 2^53 (true for any int32 A and int8 B_t with L < 2^22)."""
    return (a.to(torch.float64) @ b_t.to(torch.float64).T).to(torch.int32)


_sms: Dict[int, int] = {}


def incidence_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """A int32 [M, L] x B_t int8 [N, L] -> int32 [M, N]: the CUDA kernel on
    a CUDA tensor (pre-pass and tensor-core product, one count), the plain
    version on a CPU tensor."""
    if a.device.type == "cpu":
        return incidence_matmul_plain(a, b_t)
    dev = a.device
    _check_cuda("incidence_matmul a", a, torch.int32, 2, dev)
    _check_cuda("incidence_matmul b_t", b_t, torch.int8, 2, dev)
    m, l = a.shape
    n = b_t.shape[0]
    if b_t.shape[1] != l:
        raise ValueError(f"incidence_matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b_t.shape)}")
    if m == 0 or n == 0 or l == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=dev)
    # the kernel reads rows of L % 8 == 0 bytes from 16-byte aligned bases;
    # the snapshot pads L to 8, other callers pay a copy
    if l % 8:
        a = torch.nn.functional.pad(a, (0, 8 - l % 8))
        b_t = torch.nn.functional.pad(b_t, (0, 8 - l % 8))
        l = a.shape[1]
    if a.data_ptr() % 16:
        a = a.clone()
    if b_t.data_ptr() % 16:
        b_t = b_t.clone()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    plan = incidence_plan(m, n, l, _sms[idx])
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    # scratch: the planes int8 [4, m, l_pad], then the pre-pass counts
    # int32 [m, chunks] (4 * m * l_pad is a multiple of 512: aligned)
    planes_bytes = INCIDENCE_PLANES * m * plan["l_pad"]
    scratch = torch.empty(planes_bytes + 4 * m * plan["chunks"],
                          dtype=torch.int8, device=dev)
    fn = _lib("incidence_matmul")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(a.data_ptr(), b_t.data_ptr(), scratch.data_ptr(),
                  scratch.data_ptr() + planes_bytes, out.data_ptr(), m, n, l,
                  plan["tile_m"], plan["split"], plan["kb_per_split"],
                  plan["l_pad"], stream)
    _raise_on(code, "incidence_matmul")
    LAUNCHES["incidence_matmul"] += 1
    return out
