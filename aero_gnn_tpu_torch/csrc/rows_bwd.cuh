// The row-kernel machinery of the fused kernels, on top of chain_bwd.cuh:
// the forward ones K1 (edge_fwd_rows.cuh), K3 (node_fwd_rows.cuh) and
// K9-fwd (fused_mgn_fwd.cu), and the backward ones K2 and K8
// (edge_bwd_rows.cuh), K4 (node_bwd_rows.cuh) and K9-bwd (fused_mgn_bwd.cu).
// Each warp owns 16 rows of a 128-row chunk and runs a chain's products for
// them with no CTA barrier between products.
//
//  * WeightRing: a backward chain's weights in shared memory, all resident
//    for the CTA's life where they fit, else a ring of two slots through
//    which the products' weights stream in product order (the next one's
//    cp.async copy overlapping the current product, one CTA barrier per
//    product). bf16 keeps one copy of each weight, the forward product
//    reading it with ldmatrix and the backward one (dz @ W^T) with
//    ldmatrix.trans from the same tile; fp32 keeps W and W^T, so both FFMA
//    products stream B as float2 rows (ops/_build.py edge_bwd_operands
//    lays them out). A chain that runs only its backward products (K8,
//    kBwd) keeps only what those read: W^T once, which is the same array
//    in both types (ops/_build.py bwd_only_operands).
//  * FwdChain, WeightStream and FwdWeights: a forward chain's weights read
//    as they lie in device memory ([in][out]), resident or streamed through
//    two slots in the same way; the bf16 product reads its B tile with
//    ldmatrix.trans.
//  * RowOperand: a product's A operand, a warp's 16 rows. In bf16 it never
//    leaves registers: the mma accumulator of one product, rounded and
//    packed in pairs, is the A fragment of the next (the m16n8 accumulator
//    layout is the k16 A layout). fp32 stages it in a warp-private slice
//    of shared memory. With relu_bits / relu_grad, the ReLU masks are bits.
//  * RowTile: the forward chains' fp32 products, a register-blocked FFMA
//    tile over the warp's slice.
//  * DwAcc and dw_split: the split-K weight gradient dW = A^T D over a
//    split's chunks in 64-row slabs that cp.async double-buffers, mma.sync
//    on fragments ldmatrix.trans loads (bf16) or FFMA 8 x 8 register
//    blocks (fp32), the fp32 sum in registers for the split's whole range
//    and written once, with the bias gradient as the column sums of D; the
//    splits' partials are summed in split order by reduce_partials
//    (chain_bwd.cuh). ln_split rebuilds a split's LayerNorm column sums
//    from per-chunk sums in the row kernels' order. No float atomics: the
//    same inputs give the same bits.
#pragma once

#include "chain_bwd.cuh"

namespace chain {

constexpr int kMaxHidden = 8;  // hidden layers with masks in registers
constexpr int kSlab = 64;      // rows per weight-gradient slab

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8q..8q+7 give the row
// addresses of matrix q; lane (g, t) receives its elements [g][2t] and
// [g][2t+1] in register q.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// An [H, H] matrix of device memory (row-major) into a padded shared tile
// by cp.async, 16 bytes per copy; the caller commits and waits.
template <typename T, int H>
__device__ __forceinline__ void copy_mat_async(T* dst,
                                               const T* __restrict__ src) {
  constexpr int LD = Layout<T, H>::kLd;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = H / V;
  for (int i = threadIdx.x; i < H * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    cp_async16(dst + r * LD + c, src + size_t(r) * H + c);
  }
}

// The weight copies the products read: bf16 one per matrix (the backward
// product reads it transposed with ldmatrix.trans), fp32 two (W, then
// W^T, both [k][n], so that both products stream B as float2 rows).
template <typename T>
constexpr int kCopies = sizeof(T) == 4 ? 2 : 1;

// Matrices stored per weight: kCopies, or one where only the backward
// products run (kBwd).
template <typename T, bool kBwd = false>
constexpr int kStored = kBwd ? 1 : kCopies<T>;

// The stored matrix of product p of a chunk's 2 n_mats: the forward
// products read matrices 0 .. n_mats - 1 in order, the backward ones the
// same matrices in reverse (with fp32, their transposed copies; kBwd: the
// backward products p = n_mats .. 2 n_mats - 1 only, one matrix each).
template <typename T, bool kBwd = false>
__device__ __forceinline__ int mat_of(int p, int n_mats) {
  const bool bwd = p >= n_mats;
  const int m = bwd ? 2 * n_mats - 1 - p : p;
  if constexpr (kBwd) return m;
  return kCopies<T> == 2 ? 2 * m + bwd : m;
}

// The weights in shared memory: all resident, or a ring of two slots
// through which the products' weights stream in order (cp.async one product
// ahead; every thread of the CTA calls get() for every product). kBwd: the
// chunk's products are the backward ones, n_mats .. 2 n_mats - 1.
template <typename T, int H, bool kBwd = false>
struct WeightRing {
  static constexpr size_t kMat = size_t(H) * Layout<T, H>::kLd;
  T* slots;
  const T* wb;
  int resident, n_mats, s;

  __device__ void start() {
    if (resident) {
      for (int m = 0; m < n_mats * kStored<T, kBwd>; ++m)
        copy_mat_async<T, H>(slots + m * kMat, wb + size_t(m) * H * H);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      // the chunk's first product
      const int m0 = kBwd ? mat_of<T, kBwd>(n_mats, n_mats) : 0;
      copy_mat_async<T, H>(slots, wb + size_t(m0) * H * H);
      cp_async_commit();
    }
  }
  __device__ const T* get(int p) {
    if (resident) return slots + mat_of<T, kBwd>(p, n_mats) * kMat;
    cp_async_wait<0>();
    __syncthreads();  // the copy is visible; product s - 1 is done
    const int p_next = kBwd ? (p + 1 == 2 * n_mats ? n_mats : p + 1)
                            : (p + 1) % (2 * n_mats);
    const int m_next = mat_of<T, kBwd>(p_next, n_mats);
    copy_mat_async<T, H>(slots + ((s + 1) & 1) * kMat,
                         wb + size_t(m_next) * H * H);
    cp_async_commit();
    return slots + ((s++) & 1) * kMat;
  }
  __device__ void finish() {
    if (!resident) cp_async_wait<0>();
  }
};

// A product's A operand: the warp's 16 rows of an activation.
template <typename T, int H>
struct RowOperand;

// bf16: in registers as mma A fragments, [k block][4].
template <int H>
struct RowOperand<__nv_bfloat16, H> {
  using T = __nv_bfloat16;
  static constexpr int LD = Layout<T, H>::kLd;
  uint32_t f[H / 16][4];

  __device__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
  // rows ra / rb (the thread's rows g and g + 8) of device memory
  __device__ void from_rows(const T* row_a, const T* row_b, T*) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int kb = 0; kb < H / 16; ++kb) {
      const int c = 16 * kb + 2 * t;
      f[kb][0] = *reinterpret_cast<const uint32_t*>(row_a + c);
      f[kb][1] = *reinterpret_cast<const uint32_t*>(row_b + c);
      f[kb][2] = *reinterpret_cast<const uint32_t*>(row_a + c + 8);
      f[kb][3] = *reinterpret_cast<const uint32_t*>(row_b + c + 8);
    }
  }
  // an accumulator of already rounded values: n-tiles 2kb and 2kb + 1 are
  // k block kb
  __device__ void from_acc(const float (&v)[H / 8][4], T*) {
#pragma unroll
    for (int kb = 0; kb < H / 16; ++kb) {
      f[kb][0] = pack(v[2 * kb][0], v[2 * kb][1]);
      f[kb][1] = pack(v[2 * kb][2], v[2 * kb][3]);
      f[kb][2] = pack(v[2 * kb + 1][0], v[2 * kb + 1][1]);
      f[kb][3] = pack(v[2 * kb + 1][2], v[2 * kb + 1][3]);
    }
  }
  // acc += A @ B: kTrans false reads B = W from the [n][k] tile (ldmatrix),
  // true reads B = W^T from the same tile, [k][n] (ldmatrix.trans)
  template <bool kTrans>
  __device__ void mm(const T* w, float (&acc)[H / 8][4], T*) const {
    const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kb = 0; kb < H / 16; ++kb) {
#pragma unroll
      for (int j = 0; j < H / 8; j += 2) {
        uint32_t b[4];
        if constexpr (kTrans)
          ldsm_x4_trans(b, w + (16 * kb + (q & 1) * 8 + r8) * LD +
                               8 * (j + (q >> 1)));
        else
          ldsm_x4(b, w + (8 * (j + (q >> 1)) + r8) * LD + 16 * kb +
                         (q & 1) * 8);
        mma_bf16(acc[j], f[kb], b[0], b[1]);
        mma_bf16(acc[j + 1], f[kb], b[2], b[3]);
      }
    }
  }
};

// fp32: staged in the warp's [16][LD] slice of shared memory.
template <int H>
struct RowOperand<float, H> {
  static constexpr int LD = Layout<float, H>::kLd;

  __device__ void from_rows(const float* row_a, const float* row_b,
                            float* stg) {
    float v[H / 8][4];
    load_acc<float, H>(v, row_a, row_b);
    from_acc(v, stg);
  }
  __device__ void from_acc(const float (&v)[H / 8][4], float* stg) {
    const int g = (threadIdx.x & 31) >> 2;
    __syncwarp();  // the previous product has read the slice
    store_acc<float, H>(v, stg + g * LD, stg + (g + 8) * LD);
    __syncwarp();
  }
  // acc += A @ B, B the [k][n] tile of W or of W^T (chain.cuh mm)
  template <bool kTrans>
  __device__ void mm(const float* w, float (&acc)[H / 8][4],
                     float* stg) const {
    chain::mm<H>(stg, w, acc);
  }
};

// A forward chain's weights in product order, as they lie in device memory
// ([in][out]): n_lead leading matrices (the edge chain's W_e; the node
// chain's W1x, W1a), then ws[0 .. n_mats - n_lead - 1), then W_out.
template <typename T, int H>
struct FwdChain {
  const T *w0, *w1, *ws, *w_out;
  int n_lead, n_mats;

  __device__ const T* src(int m) const {
    if (m < n_lead) return m == 0 ? w0 : w1;
    return m < n_mats - 1 ? ws + size_t(m - n_lead) * H * H : w_out;
  }
};

// Two slots of shared memory through which weights stream one product
// ahead: prime() starts the first copy, next() waits for the copy in
// flight, returns its slot and starts the copy of the one after into the
// other slot (one CTA barrier: every thread of the CTA calls it, after its
// product on the slot it overwrites).
template <typename T, int H>
struct WeightStream {
  static constexpr size_t kMat = size_t(H) * Layout<T, H>::kLd;
  T* slots;
  int s;

  __device__ void prime(const T* src) {
    copy_mat_async<T, H>(slots + (s & 1) * kMat, src);
    cp_async_commit();
  }
  __device__ const T* next(const T* after) {
    cp_async_wait<0>();
    __syncthreads();  // the copy is visible; the product before is done
    const T* cur = slots + (s & 1) * kMat;
    ++s;
    if (after) copy_mat_async<T, H>(slots + (s & 1) * kMat, after);
    cp_async_commit();
    return cur;
  }
  __device__ void finish() { cp_async_wait<0>(); }
};

// One forward chain's weights in shared memory as [in][out] tiles: all
// resident (matrix m in slot m), or streamed in chain order through a
// WeightStream, the chunk after's first matrix following the last. Every
// thread of the CTA calls get() for every product.
template <typename T, int H>
struct FwdWeights {
  static constexpr size_t kMat = WeightStream<T, H>::kMat;
  FwdChain<T, H> c;
  WeightStream<T, H> ring;  // the slots: c.n_mats when resident, else 2
  int resident;

  __device__ void start() {
    if (resident) {
      for (int m = 0; m < c.n_mats; ++m)
        copy_mat_async<T, H>(ring.slots + m * kMat, c.src(m));
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      ring.prime(c.src(0));
    }
  }
  __device__ const T* get(int m) {
    if (resident) return ring.slots + m * kMat;
    return ring.next(c.src((m + 1) % c.n_mats));
  }
  __device__ void finish() {
    if (!resident) ring.finish();
  }
};

// A bf16 pair (one 32-bit register) as two floats, widened by its bits.
__device__ __forceinline__ float2 widen(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// fp32 forward products: a register-blocked FFMA tile. Lane (rg, cg) =
// (lane / 16, lane % 16) of the warp owns rows rg, rg + 2, .., rg + 14 of
// the warp's 16 and the column quads 4 cg + 64 q (q < H / 64). Per 4 k it
// reads each of its rows' A values as one float4 (a broadcast across its
// half-warp; the two half-warps' rows sit 4 banks apart) and per k its B
// quads (the 16 lanes of a half-warp side by side): 2 + H / 64 loads of 16
// bytes for H / 2 FMA, where chain.cuh's mm issues 2 + H / 8 (scalar A,
// float2 B). Every output is the same fma chain over k in order, so the
// same bits.
template <int H>
struct RowTile {
  static constexpr int LD = Layout<float, H>::kLd;
  static constexpr int NQ = H / 64;
  float v[8][NQ][4];

  __device__ static int rg() { return (threadIdx.x & 31) >> 4; }
  __device__ static int cg() { return threadIdx.x & 15; }
  __device__ static int row(int i) { return rg() + 2 * i; }
  __device__ static int col(int q) { return 64 * q + 4 * cg(); }

  // v = act @ w (kZero) or v += act @ w: act the warp's [16][LD] rows, w
  // an [H][LD] [in][out] tile
  template <bool kZero = true>
  __device__ void mm(const float* __restrict__ act,
                     const float* __restrict__ w) {
    if constexpr (kZero) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) v[i][q][c] = 0.f;
    }
    const float* a0 = act + rg() * LD;
    const float* b0 = w + 4 * cg();
#pragma unroll 2
    for (int k4 = 0; k4 < H; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(a0 + 2 * i * LD + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          b[q] = *reinterpret_cast<const float4*>(b0 + (k4 + kk) * LD +
                                                  64 * q);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float x = kk == 0 ? a[i].x
                        : kk == 1 ? a[i].y
                        : kk == 2 ? a[i].z
                                  : a[i].w;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            v[i][q][0] = fmaf(x, b[q].x, v[i][q][0]);
            v[i][q][1] = fmaf(x, b[q].y, v[i][q][1]);
            v[i][q][2] = fmaf(x, b[q].z, v[i][q][2]);
            v[i][q][3] = fmaf(x, b[q].w, v[i][q][3]);
          }
        }
      }
    }
  }
  // v = relu(v + b): a hidden layer's epilogue (fp32 rounds nowhere)
  __device__ void bias_relu(const float* __restrict__ b) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 b4 = *reinterpret_cast<const float4*>(b + col(q));
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[i][q][c] = fmaxf(v[i][q][c] + bv[c], 0.f);
    }
  }
  // the tile's rows to a row-major [16][ld] buffer (shared or device
  // memory), 16 bytes a store
  __device__ void store(float* dst, int64_t ld) const {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        *reinterpret_cast<float4*>(dst + row(i) * ld + col(q)) =
            make_float4(v[i][q][0], v[i][q][1], v[i][q][2], v[i][q][3]);
  }
  // the tile in the accumulator layout (rows g, g + 8 of the thread),
  // through the warp's slice `stg`
  __device__ void to_acc(float (&acc)[H / 8][4], float* stg) const {
    const int g = (threadIdx.x & 31) >> 2;
    __syncwarp();  // the product has read the slice
    store(stg, LD);
    __syncwarp();
    load_acc<float, H>(acc, stg + g * LD, stg + (g + 8) * LD);
  }
};

// Shared memory of a forward row kernel whose chain has n_mats weights
// (all resident, or the two-slot ring) and, in fp32, the warps' A operand
// slices, against the card's opt-in limit; *fits_resident says whether the
// weights fit resident (ops/hopper_fused.py edge_fwd_plan and
// ops/hopper_node.py node_fwd_plan reckon alike).
template <typename T, int H>
__host__ inline cudaError_t fwd_rows_smem(int n_mats, int* fits_resident,
                                          size_t* smem) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t mat = Layout<T, H>::kMatBytes;
  const size_t fixed = sizeof(T) == 4 ? Layout<T, H>::kActBytes : 0;
  *fits_resident = n_mats * mat + fixed <= size_t(max_smem);
  *smem = (*fits_resident ? n_mats : 2) * mat + fixed;
  return *smem <= size_t(max_smem) ? cudaSuccess : cudaErrorInvalidValue;
}

// acc = relu(rnd(rnd(acc) + b)), in registers (a hidden layer's epilogue)
template <typename T, int H>
__device__ __forceinline__ void bias_relu(float (&acc)[H / 8][4],
                                          const T* __restrict__ b) {
  using N = Num<T>;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float2 bb = N::load2(b + 8 * j + 2 * t);
    acc[j][0] = fmaxf(N::rnd(N::rnd(acc[j][0]) + bb.x), 0.f);
    acc[j][1] = fmaxf(N::rnd(N::rnd(acc[j][1]) + bb.y), 0.f);
    acc[j][2] = fmaxf(N::rnd(N::rnd(acc[j][2]) + bb.x), 0.f);
    acc[j][3] = fmaxf(N::rnd(N::rnd(acc[j][3]) + bb.y), 0.f);
  }
}

template <int H>
__device__ __forceinline__ uint64_t relu_bits(const float (&acc)[H / 8][4]) {
  uint64_t b = 0;
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (acc[j][q] > 0.f) b |= uint64_t(1) << (4 * j + q);
  return b;
}

// relu_bits of the two rows this thread wrote with store_acc, read back
template <typename T, int H>
__device__ __forceinline__ uint64_t stored_relu_bits(const T* row_a,
                                                     const T* row_b) {
  const int t = threadIdx.x & 3;
  uint64_t b = 0;
#pragma unroll
  for (int j = 0; j < H / 8; ++j) {
    const float2 x = Num<T>::load2(row_a + 8 * j + 2 * t);
    const float2 y = Num<T>::load2(row_b + 8 * j + 2 * t);
    if (x.x > 0.f) b |= uint64_t(1) << (4 * j);
    if (x.y > 0.f) b |= uint64_t(1) << (4 * j + 1);
    if (y.x > 0.f) b |= uint64_t(1) << (4 * j + 2);
    if (y.y > 0.f) b |= uint64_t(1) << (4 * j + 3);
  }
  return b;
}

// acc = rnd(acc) where the activation was > 0, else 0 (the ReLU backward)
template <typename T, int H>
__device__ __forceinline__ void relu_grad(float (&acc)[H / 8][4],
                                          uint64_t bits) {
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[j][q] = (bits >> (4 * j + q)) & 1 ? Num<T>::rnd(acc[j][q]) : 0.f;
}

template <typename T, int H>
__host__ __device__ constexpr size_t rows_fixed_smem() {
  // fp32 operand staging (kRows rows), then per warp the LayerNorm column
  // sums of ln_backward and their running totals ([2][kWarps][H] each)
  return (sizeof(T) == 4 ? Layout<T, H>::kActBytes : 0) +
         2 * 2 * size_t(kWarps) * H * sizeof(float);
}

// One CTA's [H, H] weight-gradient accumulator, summed slab by slab (A^T D
// over a slab's kSlab rows in shared memory) and written once.
template <typename T, int H>
struct DwAcc;

// bf16: each warp's TnTile (chain_bwd.cuh) in mma accumulators, fragments
// of A^T and D by ldmatrix.trans.
template <int H>
struct DwAcc<__nv_bfloat16, H> {
  static constexpr int LD = Layout<__nv_bfloat16, H>::kLd;
  static constexpr int NT = TnTile<H>::NT;
  float acc[NT][4] = {};

  __device__ void add(const __nv_bfloat16* a, const __nv_bfloat16* d) {
    const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
    const int m0 = TnTile<H>::m0(), n0 = TnTile<H>::n0();
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      uint32_t af[4];
      ldsm_x4_trans(af, a + (kk + r8 + (q >> 1) * 8) * LD + m0 + (q & 1) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, d + (kk + r8 + (q & 1) * 8) * LD + n0 + 8 * j +
                              (q >> 1) * 8);
        mma_bf16(acc[j], af, bf[0], bf[1]);
        mma_bf16(acc[j + 1], af, bf[2], bf[3]);
      }
    }
  }
  __device__ void store(float* mat) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int m0 = TnTile<H>::m0(), n0 = TnTile<H>::n0();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(mat + (m0 + g) * H + c) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(mat + (m0 + g + 8) * H + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
};

// fp32 (FFMA): thread (ty, tx) of a 16 x 16 grid owns rows B ty .. B ty +
// B - 1 (B = H / 16) and the B / 4 column quads 4 tx + 64 k, so each slab
// row costs it B / 2 float4 loads for B * B products, the quads of a
// quarter warp side by side in shared memory (no bank conflict).
template <int H>
struct DwAcc<float, H> {
  static constexpr int LD = Layout<float, H>::kLd;
  static constexpr int B = H / 16;
  static_assert(B % 4 == 0, "blocks of whole float4 vectors");
  float acc[B][B] = {};

  __device__ void add(const float* a, const float* d) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
    for (int r = 0; r < kSlab; ++r) {
      float x[B], y[B];
#pragma unroll
      for (int v = 0; v < B; v += 4) {
        const float4 xa =
            *reinterpret_cast<const float4*>(a + r * LD + B * ty + v);
        const float4 yd =
            *reinterpret_cast<const float4*>(d + r * LD + 16 * v + 4 * tx);
        x[v] = xa.x, x[v + 1] = xa.y, x[v + 2] = xa.z, x[v + 3] = xa.w;
        y[v] = yd.x, y[v + 1] = yd.y, y[v + 2] = yd.z, y[v + 3] = yd.w;
      }
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
  __device__ void store(float* mat) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int v = 0; v < B; v += 4)
        *reinterpret_cast<float4*>(mat + (B * ty + i) * H + 16 * v + 4 * tx) =
            make_float4(acc[i][v], acc[i][v + 1], acc[i][v + 2],
                        acc[i][v + 3]);
  }
};

template <typename T, int H>
__host__ __device__ constexpr size_t dw_smem() {
  return 2 * 2 * size_t(kSlab) * Layout<T, H>::kLd * sizeof(T);
}

// dW = A^T D and, where `vec` is given, the column sums of D over the
// chunks q = s, s + step, ... that next_live(q) (the first live chunk at or
// after q) leaves, in kSlab-row slabs that cp.async double-buffers through
// `smem` (dw_smem bytes); the [H, H] sum goes to `mat`, the [H] one to
// `vec`, each written once. Every thread of the CTA calls it.
template <typename T, int H, typename NextLive>
__device__ __forceinline__ void dw_split(unsigned char* smem, const T* A,
                                         const T* D, int s, int step,
                                         int n_chunks, NextLive next_live,
                                         float* mat, float* vec) {
  constexpr int LD = Layout<T, H>::kLd;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = H / V;
  constexpr size_t kTile = size_t(kSlab) * LD;
  constexpr int kParts = kThreads / H;  // column-sum partials per column
  T* tiles = reinterpret_cast<T*>(smem);  // [stage][A, D][kSlab][LD]
  const int tid = threadIdx.x;
  auto issue = [&](int q, int half, int stage) {
    const int64_t r0 = int64_t(q) * kRows + half * kSlab;
    T* ta = tiles + size_t(stage) * 2 * kTile;
    for (int i = tid; i < kSlab * PER_ROW; i += kThreads) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * V;
      cp_async16(ta + r * LD + c, A + (r0 + r) * H + c);
      cp_async16(ta + kTile + r * LD + c, D + (r0 + r) * H + c);
    }
  };
  DwAcc<T, H> acc;
  const int col = tid % H, cpart = tid / H;
  float csum = 0.f;

  int q = next_live(s), half = 0, it = 0;
  if (q < n_chunks) issue(q, 0, 0);
  cp_async_commit();
  while (q < n_chunks) {
    const int qn = half ? next_live(q + step) : q;
    const int hn = half ^ 1;
    if (qn < n_chunks) issue(qn, hn, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ta = tiles + size_t(it & 1) * 2 * kTile;
    acc.add(ta, ta + kTile);
    constexpr int kRowsPer = kSlab / kParts;
    for (int r = cpart * kRowsPer; r < (cpart + 1) * kRowsPer; ++r)
      csum += Num<T>::load1(ta + kTile + r * LD + col);
    __syncthreads();  // stage it & 1 is free for the copy after next
    q = qn;
    half = hn;
    ++it;
  }
  cp_async_wait<0>();

  acc.store(mat);
  if (!vec) return;
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
  red[cpart * H + col] = csum;
  __syncthreads();
  if (tid < H) {
    float v = 0.f;
    for (int k = 0; k < kParts; ++k) v += red[k * H + tid];
    vec[tid] = v;
  }
}

// The split-K sums of the LayerNorm column sums (dscale, dbias) that a row
// kernel's CTA s of `step` leaves in its partial, rebuilt from the sums of
// each chunk's warps, `chunk_sums` [n_chunks][2][kWarps][H] (K9-bwd, whose
// CTAs own node blocks, writes them): per warp over the chunks q = s, s +
// step, ... that live(q) admits, in that order, then the warps in order,
// each from +0 -- the row kernels' order, so the same bits. The sums of
// kB chunks are loaded before they are added. `vec` is the partial's
// [dscale | dbias] ([2][H]). Every thread of the CTA calls it.
template <int H, typename Live>
__device__ __forceinline__ void ln_split(const float* __restrict__ chunk_sums,
                                         int s, int step, int n_chunks,
                                         Live live, float* vec) {
  constexpr int kB = 4;
  for (int c = threadIdx.x; c < 2 * H; c += kThreads) {
    const float* col = chunk_sums + (c / H) * kWarps * H + c % H;
    float v[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v[w] = 0.f;
    for (int q0 = s; q0 < n_chunks; q0 += kB * step) {
      bool ok[kB];
      float x[kB][kWarps];
#pragma unroll
      for (int k = 0; k < kB; ++k) {
        const int q = q0 + k * step;
        ok[k] = q < n_chunks && live(q);
#pragma unroll
        for (int w = 0; w < kWarps; ++w)
          x[k][w] = ok[k] ? col[int64_t(q) * 2 * kWarps * H + w * H] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kB; ++k)
        if (ok[k]) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v[w] += x[k][w];
        }
    }
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += v[w];
    vec[c] = total;
  }
}

// Shared memory of a row kernel whose chain keeps n_stored weight matrices
// (all resident, or the two-slot ring) and of dw_split, against the card's
// opt-in limit; *fits_resident says whether the weights fit resident.
template <typename T, int H>
__host__ inline cudaError_t rows_smem(int n_stored, int resident,
                                      size_t* smem, int* fits_resident) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = rows_fixed_smem<T, H>();
  const size_t mat = Layout<T, H>::kMatBytes;
  *fits_resident = n_stored * mat + fixed <= size_t(max_smem);
  *smem = (resident ? n_stored : 2) * mat + fixed;
  if (*smem > size_t(max_smem) || dw_smem<T, H>() > size_t(max_smem))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace chain
