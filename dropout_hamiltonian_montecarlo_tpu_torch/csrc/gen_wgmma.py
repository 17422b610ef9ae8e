"""Write ``wgmma.cuh``: one inline-PTX wrapper of the Hopper warpgroup MMA
``wgmma.mma_async.m64nNk16.f32.bf16.bf16`` (both operands K-major in shared
memory, through descriptors) for each width N the kernels use.

    python dropout_hamiltonian_montecarlo_tpu_torch/csrc/gen_wgmma.py

The PTX names every accumulator register of the instruction (N/2 per
thread), so each width needs its own spelled-out asm statement.
"""

from pathlib import Path

# chain groups of 16 x K classes for K = 2..16, and of 8 x K for K = 8..16
# (the narrower work items of the value variant from K = 8, grad-only from 12)
WIDTHS = sorted({16 * k for k in range(2, 17)} | {8 * k for k in range(8, 17)})

HEADER = """\
// Generated by gen_wgmma.py; do not edit.
//
// Wgmma<N>::mma(d, desc_a, desc_b, scale_d): one warpgroup-wide
//   D (64 x N, f32, registers) = A (64 x 16, bf16) * B (N x 16, bf16)^T + scale_d * D
// with A and B read from shared memory through wgmma matrix descriptors, both
// K-major (no transpose).  Thread t of the warpgroup holds d[4j + e] for
// row 16 * (t / 32) + (t % 32) / 4 + 8 * (e / 2), column 8 j + 2 (t % 4) + e % 2.
#pragma once
#include <stdint.h>

template <int N>
struct Wgmma;
"""


def wrapper(n: int) -> str:
    regs = n // 2
    dlist = ", ".join(f"%{i}" for i in range(regs))
    outs = ",\n        ".join(
        ", ".join(f'"+f"(d[{i}])' for i in range(r, min(r + 8, regs)))
        for r in range(0, regs, 8))
    return f"""
template <>
struct Wgmma<{n}> {{
  __device__ __forceinline__ static void mma(float (&d)[{regs}], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{dlist}}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n}}\\n"
        : {outs}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
}};
"""


def main() -> None:
    out = Path(__file__).with_name("wgmma.cuh")
    out.write_text(HEADER + "".join(wrapper(n) for n in WIDTHS))


if __name__ == "__main__":
    main()
