"""Where a round of the fp8-EF kernels spends its time, from ``clock64``
stamps, with the send's fp32 root and with the f64 route alone.

The script copies ``csrc/fastmix_tiles.cuh``, ``csrc/launch.cuh`` and
``csrc/fastmix_ef.cu`` into ``src/repro_torch/kernels/_build/phases/``
(gitignored), stamps ``clock64()`` into the copy of the round loop (thread
0 of each block: the product ``L h``, the combine and Chebyshev update, the
send ``h = ef_send(cur, h)``, and the wait at the round's barrier), builds
a standalone program with ``nvcc`` and runs it: the kernel's time per call
(CUDA events over 20 calls after 3 warm-ups) and each phase's share of the
stamped cycles, at m=64, n=131072, K=8 (the large cell's iterate, on the
8 x 4 tile, BN=128) and at m=50, n=1500, K=8 (w8a, the 4 x 1 tile, BN=8).
It builds the round loop twice: as committed (the send takes the fp32
root ``cbrtf`` and the f64 route only next to an e4m3 rounding boundary)
and with every send on the f64 route (``(float)cbrt((double)v)``, the
parent design's root).  The committed kernels are not changed; the script
also builds the committed ``csrc/fastmix_ef.cu`` once with ``-Xptxas -v``
and prints each round-loop kernel's registers and spills.

Run on the card from the root of a checkout::

    python3 scripts/ef_round_phases.py
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT = ROOT / "src/repro_torch/kernels/_build/phases"
NVCC = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")

PHASES = r'''
__device__ unsigned long long g_phase[5];
'''

MAIN = r'''
#include <cstdio>
#include <cstdlib>
#include <vector>
static void run(int m, long long n, int K, int bn, int rows, int track) {
  const size_t mn = (size_t)m * n;
  std::vector<float> hL((size_t)m * m, 1.0f / m), hS(mn), hE(mn);
  srand(1);
  for (size_t i = 0; i < mn; ++i) {
    hS[i] = rand() / (float)RAND_MAX - 0.5f;
    hE[i] = hS[i] + 0.05f * (rand() / (float)RAND_MAX - 0.5f);
  }
  float *L, *S, *E, *O, *EO;
  cudaMalloc(&L, 4 * hL.size()); cudaMalloc(&S, 4 * mn); cudaMalloc(&E, 4 * mn);
  cudaMalloc(&O, 4 * mn); cudaMalloc(&EO, 4 * mn);
  cudaMemcpy(L, hL.data(), 4 * hL.size(), cudaMemcpyHostToDevice);
  cudaMemcpy(S, hS.data(), 4 * mn, cudaMemcpyHostToDevice);
  cudaMemcpy(E, hE.data(), 4 * mn, cudaMemcpyHostToDevice);
  for (int w = 0; w < 3; ++w)
    fastmix_ef_rounds(L, S, S, S, E, O, EO, nullptr, m, n, 1.3f, 0.3f, K, bn,
                      rows, track, 0);
  unsigned long long zero[5] = {};
  cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  cudaEvent_t a, b;
  cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 20; ++r)
    fastmix_ef_rounds(L, S, S, S, E, O, EO, nullptr, m, n, 1.3f, 0.3f, K, bn,
                      rows, track, 0);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  unsigned long long ph[5];
  cudaMemcpyFromSymbol(ph, g_phase, sizeof(ph));
  const double tot = (double)(ph[0] + ph[1] + ph[2] + ph[3]);
  printf("root=%s m=%d n=%lld K=%d rows=%d bn=%d track=%d: %.6f ms per call; "
         "clock64 shares of a round: product %.3f combine %.3f send %.3f "
         "barrier %.3f (%.0f cycles per round); %s\n", ROOT_NAME, m, n, K,
         rows, bn, track, ms / 20, ph[0] / tot, ph[1] / tot, ph[2] / tot,
         ph[3] / tot, tot / (double)ph[4] / K,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(L); cudaFree(S); cudaFree(E); cudaFree(O); cudaFree(EO);
}
int main() {
  run(64, 131072, 8, 128, 8, 1);
  run(64, 131072, 8, 128, 8, 0);
  run(50, 1500, 8, 8, 4, 1);
  return 0;
}
'''


def patch(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"ef_round_phases: the round loop changed; no "
                         f"{old.strip().splitlines()[0]!r} to stamp")
    return text.replace(old, new, 1)


def instrumented_header(f64_route: bool) -> str:
    hdr = (CSRC / "fastmix_tiles.cuh").read_text()
    hdr = patch(hdr, "constexpr float kFp8Max = 448.0f;\n",
                "constexpr float kFp8Max = 448.0f;\n" + PHASES)
    if f64_route:
        hdr = patch(hdr, "__nv_cvt_fp8_to_halfraw(send_fp8(__fsub_rn(cur, h))",
                    "__nv_cvt_fp8_to_halfraw(send_fp8_f64(__fsub_rn(cur, h))")
    hdr = patch(hdr, "  for (int round = 0; round < K; ++round) {\n",
                "  long long tp[4] = {}, c0 = clock64(), c1 = 0, c2 = 0, "
                "c3 = 0;\n  for (int round = 0; round < K; ++round) {\n")
    hdr = patch(hdr, "      product<R, C>(Mt, ms, src, bn, m, i0, c, acc);\n",
                "      product<R, C>(Mt, ms, src, bn, m, i0, c, acc);\n"
                "      c1 = clock64();\n")
    hdr = patch(hdr, "      if constexpr (EF) {\n        // the send",
                "      c2 = clock64();\n      if constexpr (EF) {\n"
                "        // the send")
    hdr = patch(hdr, """        put_sent<WIRE == kWireBf16, R, C>(dst, bn, m, i0, c, cur);
      }
    }
    __syncthreads();
  }
""", """        put_sent<WIRE == kWireBf16, R, C>(dst, bn, m, i0, c, cur);
      }
      c3 = clock64();
    }
    __syncthreads();
    const long long c4 = clock64();
    tp[0] += c1 - c0; tp[1] += c2 - c1; tp[2] += c3 - c2; tp[3] += c4 - c3;
    c0 = c4;
  }
  if (EF && threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i)
      atomicAdd(&g_phase[i], (unsigned long long)tp[i]);
    atomicAdd(&g_phase[4], 1ull);
  }
""")
    return hdr


def build(f64_route: bool) -> Path:
    name = "f64" if f64_route else "fp32"
    work = OUT / name
    work.mkdir(parents=True, exist_ok=True)
    (work / "fastmix_tiles.cuh").write_text(instrumented_header(f64_route))
    (work / "launch.cuh").write_text((CSRC / "launch.cuh").read_text())
    (work / "harness.cu").write_text(
        f'#define ROOT_NAME "{name}"\n' +
        (CSRC / "fastmix_ef.cu").read_text() + MAIN)
    exe = work / "harness"
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *NVCC, "-o", str(exe), str(work / "harness.cu")],
                   check=True)
    return exe


def registers() -> None:
    """ptxas's registers and spills of the committed round-loop kernels."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run(
        [nvcc, *NVCC, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", str(OUT / "libfastmix_ef.so"), str(CSRC / "fastmix_ef.cu")],
        capture_output=True, text=True, check=True)
    text = out.stdout + out.stderr
    if shutil.which("c++filt"):
        text = subprocess.run(["c++filt"], input=text, capture_output=True,
                              text=True, check=True).stdout
    log = text.splitlines()
    for i, line in enumerate(log):
        if "Function properties for" in line and "rounds_kernel" in line:
            name = line.split("for ")[-1].strip()
            print(f"ptxas {name}: {log[i + 1].strip()}; "
                  f"{log[i + 2].split(':', 1)[-1].strip()}", flush=True)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    registers()
    for f64_route in (False, True):
        subprocess.run([str(build(f64_route))], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
