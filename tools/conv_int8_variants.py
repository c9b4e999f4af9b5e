"""What bounds the Hopper int8 convolution: variants of ``csrc/conv_int8.cu``
timed side by side on the card, and one that counts cycles inside it.

Run on the machine with the card, from the repository root:

    python3 tools/conv_int8_variants.py [--variants a,b,..] [--sites s,t,..]

Each variant is a copy of ``csrc/`` with string edits to ``conv_int8.cu``
(and optionally a cap on the tile width ``conv_plan`` picks), built into its
own library under ``build/variants/`` and swapped in for the wrapper's;
every variant runs the same seeded inputs at the serving flagship's sites,
in turns, two rounds (CUDA-event medians of 20 calls), and says whether its
f32 output still equals the plain version's (the variants that drop work
do not). ``tests/test_torch_quant_fused.py`` checks on the CPU that every
variant's edits still apply to the kernel's source. ``timing`` adds ``clock64`` counters: per block, the cycles the
first consumer thread waits for full stages, spends from the wait's end to
the previous stage's completion (``wgmma.wait_group 1``), in the stage
release, in the epilogue and in all; the cycles the first producer thread
waits for empty stages and in all.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
SITES = ("rpn/shared@p2", "cls/conv1", "mask/conv1", "bb/conv1", "bb/res4b/conv2", "fpn/c5p5", "bb/res2a/conv1",
         "bb/res5b/conv2")

_CONSUMER_LOOP = """    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {"""
_TIMING = [
    ("#include <string.h>\n", "#include <string.h>\n__device__ unsigned long long g_dbg[1024][8];\n"),
    ("""        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);""", """        const int s = it % kStages;
        const long long c0 = clock64();
        mbar_wait(&full[s], (it / kStages) & 1);
        const long long c1 = clock64();
        d_wait += c1 - c0;"""),
    ("""        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (kt > kt0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);""",
     """        wgmma_wait<1>();  // the previous stage's products are done: release it
        const long long c2 = clock64();
        d_mma += c2 - c1;
        if (kt > kt0 && (tid & 127) == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        d_rel += clock64() - c2;"""),
    (_CONSUMER_LOOP + "\n      const int z = u / tiles",
     """    int it = 0;
    long long d_wait = 0, d_mma = 0, d_rel = 0, d_epi = 0, d_all = clock64();
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / tiles"""),
    ("""      epilogue<BN>(p, acc, m0, n0, r0, lane);
    }""", """      const long long e0 = clock64();
      epilogue<BN>(p, acc, m0, n0, r0, lane);
      d_epi += clock64() - e0;
    }
    if (tid == 0) {
      unsigned long long* d = g_dbg[blockIdx.x];
      d[0] = d_wait; d[1] = d_mma; d[2] = d_rel; d[3] = d_epi; d[4] = clock64() - d_all; d[7] = it;
    }"""),
    ("""        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);""", """        const long long c0 = clock64();
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        p_wait += clock64() - c0;"""),
    ("""    int it = 0;                        // stages so far, over all units""",
     """    int it = 0;                        // stages so far, over all units
    long long p_wait = 0, p_all = clock64();"""),
    ("""    asm volatile("cp.async.wait_all;\\n" ::: "memory");""", """    asm volatile("cp.async.wait_all;\\n" ::: "memory");
    if (t == 0) { g_dbg[blockIdx.x][5] = p_wait; g_dbg[blockIdx.x][6] = clock64() - p_all; }"""),
    ("""// x: n f32 (is_bf16 0) or bf16 (1) values; q: n int8.""",
     """extern "C" int caesar_dbg_read(void* host, int clear) {
  if (clear) return (int)cudaMemset(g_dbg_ptr(), 0, sizeof(g_dbg));
  return (int)cudaMemcpyFromSymbol(host, g_dbg, sizeof(g_dbg));
}

// x: n f32 (is_bf16 0) or bf16 (1) values; q: n int8."""),
    ("__device__ unsigned long long g_dbg[1024][8];\n", """__device__ unsigned long long g_dbg[1024][8];
static void* g_dbg_ptr() { void* p = nullptr; cudaGetSymbolAddress(&p, g_dbg); return p; }
"""),
]
# the producer's row descriptors read from shared memory at every stage, as
# the kernel first did (the producer at 40 registers, the consumers 232)
_ROWS_IN_SHARED_MEMORY = [
    ("setmaxnreg.dec.sync.aligned.u32 56;", "setmaxnreg.dec.sync.aligned.u32 40;"),
    ("setmaxnreg.inc.sync.aligned.u32 224;", "setmaxnreg.inc.sync.aligned.u32 232;"),
    ("""      int4 mine[8];  // this thread's rows, in registers: a shared-memory read per stage measured slower
#pragma unroll
      for (int i = 0; i < 8; ++i) mine[i] = rows[rg + 16 * i];
""", ""),
    ("          const int4 ri = mine[i];", "          const int4 ri = rows[r];"),
]
# variant -> (edits in order, cap on the tile width)
VARIANTS: Dict[str, Tuple[List[Tuple[str, str]], int]] = {
    "kernel": ([], 0),
    "timing": (_TIMING, 0),
    "no_a": ([("        cp_async16(as + r * kBK + ((j ^ (r & 7)) << 4), src, ok);\n",
               "        if (p.relu == 7) cp_async16(as + r * kBK + ((j ^ (r & 7)) << 4), src, ok);\n")], 0),
    "no_b": ([("""        if (t == 0) {
          mbar_expect_tx(&full[s], BN * kBK);
          tma_load_2d(Bs + s * BN * kBK, &wmap, &full[s], kt * kBK, n0);
        }""", """        if (t == 0) mbar_arrive(&full[s]);""")], 0),
    "no_epilogue": ([("      epilogue<BN>(p, acc, m0, n0, r0, lane);",
                      "      if (p.relu == 7) epilogue<BN>(p, acc, m0, n0, r0, lane);")], 0),
    "rows_in_shared_memory": (_ROWS_IN_SHARED_MEMORY, 0),
    "bn128": ([], 128),
    "bn128_stages6": ([("constexpr int kStages = 4;", "constexpr int kStages = 6;")], 128),
    "warp_arrivals": ([
        ("// ------------------------------------------------ Hopper main loop (wgmma)\n",
         """__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\\n" ::"n"(N));
}

// ------------------------------------------------ Hopper main loop (wgmma)
"""),
        ("      mbar_init(&full[s], 128 + 1);", "      mbar_init(&full[s], 4 + 1);"),
        ("""        cp_async_arrive(&full[s]);
      }
    }
    asm volatile("cp.async.wait_all;\\n" ::: "memory");""", """        cp_async_commit();
        if (it >= 2) {  // stage it - 2 has landed for every lane of this warp: one arrival for the warp
          cp_async_wait<2>();
          asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
          __syncwarp();
          if ((t & 31) == 0) mbar_arrive(&full[(it - 2) % kStages]);
        }
      }
    }
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncwarp();
    if ((t & 31) == 0)
      for (int i = (it > 2 ? it - 2 : 0); i < it; ++i) mbar_arrive(&full[i % kStages]);""")], 0),
}


def variant_source(name: str) -> str:
    """conv_int8.cu with the variant's edits, each of which must apply."""
    text = (ROOT / "caesar_mrcnn_tpu_torch" / "csrc" / "conv_int8.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: edit does not apply once: {old[:70]!r}")
        text = text.replace(old, new)
    return text


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--sites", default=",".join(SITES))
    args = ap.parse_args()

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from caesar_mrcnn_tpu_torch import kernel_bench as kb
    from caesar_mrcnn_tpu_torch.ops import _kernels
    from caesar_mrcnn_tpu_torch.ops import library as L
    from caesar_mrcnn_tpu_torch.ops import quant as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sites = {s.name: s for s in kb.int8_sites(chip_smoke.serving_config(), 512, 100)}
    cases = {}
    for name in args.sites.split(","):
        s = sites[name]
        x = torch.randint(-127, 128, (s.batch, s.h, s.w, s.cin), generator=gen, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (s.cout, s.k, s.k, s.cin), generator=gen, device=dev, dtype=torch.int8)
        x, w = Q.hopper_operands(x, w)
        sw = torch.rand(s.cout, generator=gen, device=dev) * 1e-3 + 1e-6
        b = torch.rand(s.cout, generator=gen, device=dev) * 2 - 1
        cases[name] = (s, x, w, sw, b, Q.conv2d_int8_plain(x, w, sw, b, s.stride, s.pads, s.relu))

    libs = {}
    for name in args.variants.split(","):
        d = ROOT / "build" / "variants" / name.replace("/", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(ROOT / "caesar_mrcnn_tpu_torch" / "csrc", d / "csrc")
        (d / "csrc" / "conv_int8.cu").write_text(variant_source(name))
        _kernels.CSRC, _kernels.BUILD_DIR = d / "csrc", d / "lib"
        libs[name] = _kernels.load(_kernels.build()[0])
    tiles = Q._tiles
    print(f"variants of conv_int8.cu [{kb.card()}]")
    for rnd in range(2):
        for name, lib in libs.items():
            _kernels.library = lambda lib=lib: lib
            L._WEIGHT_MAPS.clear()
            cap = VARIANTS[name][1]
            Q._tiles = tiles if not cap else (
                lambda m, n, k, sms, cap=cap: (min(tiles(m, n, k, sms)[0], cap), tiles(m, n, k, sms)[1]))
            row = []
            for site, (s, x, w, sw, b, ref) in cases.items():
                def call():
                    return Q.conv2d_int8(x, w, sw, b, s.stride, s.pads, s.relu)

                same = torch.equal(call(), ref)
                row.append(f"{site} {kb.median_ms(call, kb.REPS):.4f}{'' if same else ' (differs)'}")
                if name == "timing" and rnd == 0:
                    buf = np.zeros((1024, 8), np.uint64)
                    lib.caesar_dbg_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
                    lib.caesar_dbg_read(None, 1)
                    call()
                    torch.cuda.synchronize()
                    lib.caesar_dbg_read(buf.ctypes.data, 0)
                    blocks = buf[:, 4] > 0
                    c = buf[blocks].astype(np.float64).mean(0)
                    n = max(c[7], 1)
                    print(f"  timing {site}: {int(blocks.sum())} blocks, {c[7]:.0f} stages each; cycles per stage: "
                          f"consumer waits for a full stage {c[0] / n:.0f}, to the previous stage's completion "
                          f"{c[1] / n:.0f}, releasing {c[2] / n:.0f}, epilogue {c[3] / n:.0f}, in all {c[4] / n:.0f}; "
                          f"producer waits for an empty stage {c[5] / n:.0f}, in all {c[6] / n:.0f}", flush=True)
            print(f"round {rnd} {name}: " + "; ".join(row), flush=True)
        Q._tiles = tiles


if __name__ == "__main__":
    main()
