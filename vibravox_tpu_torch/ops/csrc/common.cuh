// Helpers shared by the hand-written kernels of this directory: conversions
// between a storage type and the float32 the kernels compute in, torch's
// reflect index, and the tensor-core and copy primitives (mma.sync in bf16
// and in 3xTF32, ldmatrix, cp.async).  Each kernel source is its own
// translation unit, so these live in an unnamed namespace.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// f32 value rounded to the precision of the storage type T
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// torch's reflect index, exact for an overhang smaller than t_len
__device__ __forceinline__ int reflect(int g, int t_len) {
  if (g < 0) g = -g;
  if (g > t_len - 1) g = 2 * (t_len - 1) - g;
  return g;
}

// ---- bf16 tensor cores: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 ----
//
// Fragments (PTX ISA), lane = 4 g + q, each 32-bit register two bf16 with
// the lower index in the lower half:
//   A (16 x 16, m x k): a0 = (g, 2q..2q+1), a1 = (g+8, 2q..2q+1),
//                       a2 = (g, 2q+8..2q+9), a3 = (g+8, 2q+8..2q+9);
//   B (16 x 8, k x n):  b0 = (2q..2q+1, g), b1 = (2q+8..2q+9, g);
//   C (16 x 8, f32):    c0, c1 = (g, 2q..2q+1), c2, c3 = (g+8, 2q..2q+1).
// tests/test_torch_residual_mma.py and tests/test_torch_residual_fwd_mma.py
// emulate these maps and the kernels' walks.

// c += A . B on one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- float32 on the tensor cores: 3xTF32 mma.sync.aligned.m16n8k8 ----------
//
// Fragments (PTX ISA), lane = 4 g + q, one f32 (TF32) value a register:
//   A (16 x 8, m x k):  a0 = (g, q), a1 = (g+8, q), a2 = (g, q+4), a3 = (g+8, q+4);
//   B (8 x 8, k x n):   b0 = (q, g), b1 = (q+4, g);
//   C (16 x 8, f32):    as m16n8k16's.
// An ldmatrix of 32-bit data hands lane 4 g + q word q of row g of each
// 8 x 4 matrix (8 rows of 16 bytes), which is exactly these A and B
// registers: A from a time-major plane, B from weights staged [n][k].
// Byte for byte the addresses are those of the bf16 m16n8k16 step.
// tests/test_torch_residual_tf32.py emulates these maps and the split.
//
// A TF32 product keeps 10 mantissa bits of each operand, about 5e-4 of
// relative error.  Split every operand v into hi = tf32(v) and lo = tf32(v -
// hi) (round to nearest, ties away, as cvt.rna; v - hi is exact in f32) and
// sum lo.hi + hi.lo + hi.hi: the dropped lo.lo and the rounding of lo are
// ~2^-21 of |v|, float32's own order, so the sums hold the float32 bars.

// v rounded to TF32 (10 mantissa bits; round to nearest, ties away): the
// integer form of cvt.rna.tf32.f32, equal to it for every finite v, in two
// instructions where ptxas lowers cvt.rna to four (a NaN check and a
// select besides).  A NaN may leave hi as a zero, but then lo = v - hi is
// NaN and carries it into the sum.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// the 3xTF32 split of N f32 registers (as ldmatrix gives them) into hi, lo
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&v)[N], uint32_t (&hi)[N], uint32_t (&lo)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float f = __uint_as_float(v[r]);
    hi[r] = tf32_rna(f);
    lo[r] = tf32_rna(f - __uint_as_float(hi[r]));
  }
}

// c += A . B on one m16n8k8 tile, TF32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += A . B to float32 accuracy: lo.hi + hi.lo, then hi.hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// ldmatrix.x4 (not transposed): lane l gives the address of row l % 8 of
// the 8 x 8 bf16 matrix l / 8, 16 bytes, 16-byte aligned; register r of
// lane 4 g + q receives row g, columns 2q and 2q + 1 of matrix r.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ldmatrix.x4.trans: lane l gives the address of row l % 8 of the 8 x 8
// bf16 matrix l / 8, as above; register r of lane 4 g + q receives rows 2q
// and 2q + 1 of column g of matrix r (the matrix transposed).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// ldmatrix.x2.trans: two matrices, from the addresses of lanes 0-15
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// 16 bytes from global to shared memory without passing through registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of the cp.async groups this thread committed are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// waits for every cp.async group this thread committed
__device__ __forceinline__ void cp_async_wait_committed() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
