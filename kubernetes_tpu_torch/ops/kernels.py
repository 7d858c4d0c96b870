"""The port's two hand-written CUDA kernels, their wrappers, plain versions
and launch counters.

  capacity_fit       csrc/capacity_fit.cu — replaces the TPU kernel
                     kubernetes_tpu/ops/pallas_kernels.py:90
                     capacity_fits_pallas (the PodFitsResources mask);
                     capacity_headroom launches the same kernel for the
                     wave, which also writes the per-class headroom of
                     kubernetes_tpu/engine/waves.py _class_capacity.
  incidence_matmul   csrc/incidence_matmul.cu — replaces
                     kubernetes_tpu/ops/pallas_kernels.py:144
                     incidence_matmul_pallas (the affinity incidence
                     product behind precompute_static): int8 tensor cores
                     over byte planes of A, launched by the plan of
                     incidence_plan.

Each wrapper dispatches on the device of the tensors it is given: on a
CUDA tensor it launches its kernel on PyTorch's current stream (and raises
if the launch fails); on a CPU tensor it runs the plain PyTorch version
beside it; any other device raises. There is no fallback from one to the
other. The sources are compiled at first use with nvcc (sm_90a, a plain C
interface, loaded with ctypes) into ``.torch_kernels/`` at the root of the
checkout. The launch path is kept lean because these kernels run for a
few microseconds: one combined operand check, one ``torch.empty`` per
output, the bound C function cached, the current raw stream read without
building a ``Stream`` object, and the device switched only when the
operands are not on the current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

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
# resource columns the capacity kernel takes (kMaxR in the source: a
# block's class row sits in a static shared array of 40 ints)
CAPACITY_MAX_R = 40
# returned by a launch function for a plan or arguments it cannot run
# (never a cudaError_t, which are all >= 0)
BAD_PLAN = -1

# name -> (source file, exported C function, ctypes argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNELS = {
    "capacity_fit": ("capacity_fit.cu", "capacity_fit_launch",
                     (_P,) * 8 + (_I,) * 3 + (_P,)),
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


def _on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); a tensor on any other device raises."""
    if t.is_cuda:
        return True
    if t.is_cpu:
        return False
    raise ValueError(f"{name}: tensor on {t.device}, expected cuda or cpu")


def _check_cuda(name: str, dev: int, operands) -> None:
    """The one check of a launch's operands: each (label, tensor, dtype,
    shape) must lie on CUDA device `dev`, have that dtype and shape, and
    be contiguous."""
    for label, t, dtype, shape in operands:
        if t.dtype is dtype and t.get_device() == dev and t.shape == shape \
                and t.is_contiguous():
            continue
        raise ValueError(
            f"{name} {label}: {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ', not contiguous'}; expected "
            f"{dtype} {tuple(shape)} contiguous on cuda:{dev}")


def _launch(name: str, dev: int, *args) -> None:
    """Call kernel `name`'s C launch function with `args` and PyTorch's
    current raw stream of CUDA device `dev`, which is made the current
    device for the call only when it is not already; raise on a non-zero
    return, and count the launch."""
    fn = _libs.get(name) or _lib(name)
    if torch._C._cuda_getDevice() == dev:
        code = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if code == BAD_PLAN:
        raise RuntimeError(f"{name}: the kernel refused its launch plan "
                           f"or arguments")
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {code}")
    LAUNCHES[name] += 1


_sms: Dict[int, int] = {}


def _sm_count(dev: int) -> int:
    sms = _sms.get(dev)
    if sms is None:
        sms = _sms[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


# ---------------------------------------------------------------------------
# capacity_fit
# ---------------------------------------------------------------------------

def capacity_fit_plain(pod_req: torch.Tensor, alloc: torch.Tensor,
                       requested: torch.Tensor,
                       zero_req: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The plain version: PodFitsResources (predicates.go:556-624) without
    the pod-count check, as the broadcast compare over a [P, N, R] cube;
    with `zero_req` [P] bool the zero-request override ORed in
    (predicates.go:576-578), without it left out (the TPU kernel's
    function). int32 in, bool [P, N] out. Column layout: 0=cpu 1=mem
    2=gpu 3=scratch 4=overlay 5..=extended."""
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
    fit = plain & scratch_ok & overlay_ok
    return fit if zero_req is None else fit | zero_req[:, None]


_BIG = 2 ** 31 - 1   # "no limit" in the headroom


def class_capacity_plain(pod_req: torch.Tensor, zero_req: torch.Tensor,
                         alloc: torch.Tensor, requested: torch.Tensor,
                         pod_count: torch.Tensor, allowed_pods: torch.Tensor
                         ) -> torch.Tensor:
    """The plain version of the headroom, the wave engine's
    _class_capacity (kubernetes_tpu/engine/waves.py:318): cap[C, N] int32,
    how many MORE pods of class c fit on node n, by exact integer division
    per resource column (the resources_fit semantics, overlay->scratch
    fallback and zero-request early exit included) plus the allowed-pod
    ceiling. Every int32 difference wraps, as in the reference; operands
    are clamped non-negative before the (floor) division."""
    rem = alloc - requested                             # [N,R]
    req = pod_req                                       # [C,R]

    def col_cap(rem_col, req_col):                      # [N],[C] -> [C,N]
        r = req_col.clamp(min=1)[:, None]
        cap = rem_col.clamp(min=0)[None, :] // r
        return torch.where(req_col[:, None] > 0, cap, _BIG)

    plain_cols = [0, 1, 2] + list(range(NUM_BASE_RESOURCES, alloc.shape[1]))
    cap = torch.full((req.shape[0], alloc.shape[0]), _BIG, dtype=torch.int32,
                     device=alloc.device)
    for col in plain_cols:
        cap = torch.minimum(cap, col_cap(rem[:, col], req[:, col]))
    no_ov = alloc[:, R_OVERLAY] == 0                    # [N]
    scr_rem = torch.where(no_ov,
                          alloc[:, R_SCRATCH] - requested[:, R_SCRATCH]
                          - requested[:, R_OVERLAY],
                          rem[:, R_SCRATCH])
    scr_add = torch.where(no_ov[None, :],
                          (req[:, R_SCRATCH] + req[:, R_OVERLAY])[:, None],
                          req[:, R_SCRATCH][:, None])   # [C,N]
    scr_cap = torch.where(scr_add > 0,
                          scr_rem.clamp(min=0)[None, :]
                          // scr_add.clamp(min=1), _BIG)
    cap = torch.minimum(cap, scr_cap)
    ov_cap = torch.where(no_ov[None, :], _BIG,
                         col_cap(rem[:, R_OVERLAY], req[:, R_OVERLAY]))
    cap = torch.minimum(cap, ov_cap)
    cap = torch.where(zero_req[:, None], _BIG, cap)
    count_cap = (allowed_pods - pod_count).clamp(min=0)
    return torch.minimum(cap, count_cap[None, :])


def _capacity_launch(pod_req, zero_req, alloc, requested, pod_count,
                     allowed_pods, name):
    """One launch of the capacity kernel: fit [C, N] bool, and cap [C, N]
    int32 when pod_count is given (else None)."""
    dev = pod_req.get_device()
    if pod_req.dim() != 2 or alloc.dim() != 2:
        raise ValueError(f"{name}: shapes {tuple(pod_req.shape)}, "
                         f"{tuple(alloc.shape)}, expected [C, R], [N, R]")
    c, r = pod_req.shape
    n = alloc.shape[0]
    if not NUM_BASE_RESOURCES <= r <= CAPACITY_MAX_R:
        raise ValueError(f"{name}: {r} resource columns, the kernel takes "
                         f"{NUM_BASE_RESOURCES}..{CAPACITY_MAX_R}")
    i32 = torch.int32
    operands = [("pod_req", pod_req, i32, (c, r)),
                ("alloc", alloc, i32, (n, r)),
                ("requested", requested, i32, (n, r))]
    if zero_req is not None:
        operands.append(("zero_req", zero_req, torch.bool, (c,)))
    if pod_count is not None:
        operands += [("pod_count", pod_count, i32, (n,)),
                     ("allowed_pods", allowed_pods, i32, (n,))]
    _check_cuda(name, dev, operands)
    # new_empty: the operand's device without parsing a device argument
    fit = pod_req.new_empty((c, n), dtype=torch.bool)
    cap = None if pod_count is None else pod_req.new_empty((c, n))
    if c == 0 or n == 0:
        return fit, cap
    _launch("capacity_fit", dev, pod_req.data_ptr(),
            None if zero_req is None else zero_req.data_ptr(),
            alloc.data_ptr(), requested.data_ptr(),
            None if cap is None else pod_count.data_ptr(),
            None if cap is None else allowed_pods.data_ptr(),
            fit.data_ptr(), None if cap is None else cap.data_ptr(),
            c, n, r)
    return fit, cap


def capacity_fit(pod_req: torch.Tensor, alloc: torch.Tensor,
                 requested: torch.Tensor,
                 zero_req: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The resource-fit mask [P, N] bool: without `zero_req` the TPU
    kernel's function (zero-request override excluded), with it the
    override folded in (predicates.resources_fit). The CUDA kernel on a
    CUDA tensor (one launch), the plain version on a CPU tensor."""
    if _on_card(pod_req, "capacity_fit"):
        return _capacity_launch(pod_req, zero_req, alloc, requested, None,
                                None, "capacity_fit")[0]
    return capacity_fit_plain(pod_req, alloc, requested, zero_req)


def capacity_headroom(pod_req: torch.Tensor, zero_req: torch.Tensor,
                      alloc: torch.Tensor, requested: torch.Tensor,
                      pod_count: torch.Tensor, allowed_pods: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wave's capacity step: (fit [C, N] bool with the zero-request
    override, cap [C, N] int32 headroom of class_capacity_plain). One
    launch of the capacity kernel on a CUDA tensor (counted under
    LAUNCHES["capacity_fit"]), the plain versions on a CPU tensor."""
    if _on_card(pod_req, "capacity_headroom"):
        return _capacity_launch(pod_req, zero_req, alloc, requested,
                                pod_count, allowed_pods,
                                "capacity_headroom")
    return (capacity_fit_plain(pod_req, alloc, requested, zero_req),
            class_capacity_plain(pod_req, zero_req, alloc, requested,
                                 pod_count, allowed_pods))


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


def incidence_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """A int32 [M, L] x B_t int8 [N, L] -> int32 [M, N]: the CUDA kernel on
    a CUDA tensor (pre-pass and tensor-core product, one count), the plain
    version on a CPU tensor."""
    if not _on_card(a, "incidence_matmul"):
        return incidence_matmul_plain(a, b_t)
    dev = a.get_device()
    if a.dim() != 2 or b_t.dim() != 2:
        raise ValueError(f"incidence_matmul: shapes {tuple(a.shape)} x "
                         f"{tuple(b_t.shape)}, expected [M, L] x [N, L]")
    m, l = a.shape
    n = b_t.shape[0]
    _check_cuda("incidence_matmul", dev,
                (("a", a, torch.int32, (m, l)),
                 ("b_t", b_t, torch.int8, (n, l))))
    if m == 0 or n == 0 or l == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=a.device)
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
    plan = incidence_plan(m, n, l, _sm_count(dev))
    out = a.new_empty((m, n))
    # scratch: the planes int8 [4, m, l_pad], then the pre-pass counts
    # int32 [m, chunks] (4 * m * l_pad is a multiple of 512: aligned)
    planes_bytes = INCIDENCE_PLANES * m * plan["l_pad"]
    scratch = b_t.new_empty(planes_bytes + 4 * m * plan["chunks"])
    _launch("incidence_matmul", dev, a.data_ptr(), b_t.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + planes_bytes,
            out.data_ptr(), m, n, l, plan["tile_m"], plan["split"],
            plan["kb_per_split"], plan["l_pad"])
    return out
