// Fused scene-coordinate head chain, backward, for Hopper (sm_90a).
//
// Replaces acezero_tpu/ops/fused_head.py::_backward_kernel (launched by
// _run_backward): a recompute-based backward of the chain that
// fused_head_fwd.cu runs forward. Per row tile it
//   1. reruns the forward exactly as the forward kernel does (f32
//      accumulation, + b, ReLU, bf16 rounding, bf16 residual adds) and
//      records acts_in[l] (the bf16 input of layer l) and the ReLU mask
//      mask[l] = (pre_l > 0) of the f32 pre-activation;
//   2. walks back from g = bf16(g_in), g_res = 0: for l = L-1 .. 0,
//        if res_after[l]: g = bf16(g + g_res); g_res = g
//        gpre[l] = g * mask[l]                  (exact in bf16)
//        g = bf16(gpre[l] @ W[l]^T)             (f32 accumulation)
//   3. writes dx = bf16(g + g_res), gpre and acts_in.
// dW = acts_in^T gpre and db = sum(gpre) run outside, as in JAX.
//
// Shapes: x, g, dx (B, 512) bf16; W (L, 512, 512) bf16 in (cin, cout)
// layout; b (L, 512) f32; gpre, acts_in (L, B, 512) bf16; mask scratch
// (L, B, 64) uint8, one bit per column. Any B (the ragged last tile is
// masked), any L <= 64 and any res_after.
//
// Bound on an H100 SXM at the mapping shape (B = 5,120, L = 8): the
// recompute and the walk back are 4 * B * 512^2 * L = 42.9 GFLOP, about
// 0.043 ms at the 989 TFLOP/s bf16 dense peak; the bytes that must move
// (x, g and dx, gpre and acts_in, W once) are 0.104 GB, about 0.031 ms at
// 3.35 TB/s. So the kernel is bound by operations.
//
// Design: the forward kernel's, run twice. One block of 16 warps owns a
// 64-row tile for the whole chain, forward and back, with two 64 x 512 bf16
// activation buffers in shared memory (forward: working h and residual
// stream; backward: g and g_res). Every layer's W streams through shared
// memory in double-buffered cp.async stages shared by all warps: row slabs
// W[k0:k0+32, :] going forward, column slabs W[:, c0:c0+32] going back.
// The backward product reads W transposed with no copy: a column-major
// WMMA fragment load of the row-major column slab is a fragment of W^T.
// acts_in and gpre go to device memory as they are produced (they are
// outputs); the ReLU masks go to a small global scratch as bits, because
// after a residual layer the next layer's input is the residual stream and
// the mask cannot be read back from acts_in. At B = 5,120 there are only
// 80 tiles for 132 SMs (one block per SM for shared memory): the card is
// under-filled, which is the first thing to fix after correctness.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int C = 512;          // head width
constexpr int BM = 64;          // rows per block
constexpr int LDS = C + 8;      // padded activation row (elements)
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int WARP_ROWS = 32;   // rows per warp slab
constexpr int WARP_COLS = 64;   // cols per warp slab
constexpr int FR = WARP_ROWS / 16;
constexpr int FC = WARP_COLS / 16;
constexpr int MAX_LAYERS = 64;
constexpr int VEC = 8;          // bf16 per 16-byte vector
constexpr int MASK_BYTES = C / 8;

constexpr int KS = 32;          // reduction rows per W stage
constexpr int LDF = C + 8;      // forward stage row: W[k][0:512]
constexpr int LDB = KS + 8;     // backward stage row: W[k][c0:c0+32]
constexpr size_t ACT_BYTES = size_t(BM) * LDS * sizeof(__nv_bfloat16);
constexpr size_t WST_FWD = size_t(KS) * LDF * sizeof(__nv_bfloat16);
constexpr size_t WST_BWD = size_t(C) * LDB * sizeof(__nv_bfloat16);
constexpr size_t WST_BYTES = WST_FWD > WST_BWD ? WST_FWD : WST_BWD;
constexpr size_t SCRATCH_BYTES = size_t(WARPS) * 16 * 16 * sizeof(float);
constexpr size_t SMEM_BYTES = 2 * ACT_BYTES + 2 * WST_BYTES + SCRATCH_BYTES;
static_assert(SMEM_BYTES <= 232448, "shared memory over the per-block limit");

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Forward stage: W rows [k0, k0 + KS), all 512 columns.
__device__ __forceinline__ void load_w_rows(__nv_bfloat16* dst, const __nv_bfloat16* wl, int k0, int tid) {
    for (int i = tid; i < KS * (C / VEC); i += THREADS) {
        const int r = i / (C / VEC);
        const int c = (i % (C / VEC)) * VEC;
        cp_async16(dst + r * LDF + c, wl + size_t(k0 + r) * C + c);
    }
}

// Backward stage: W columns [c0, c0 + KS), all 512 rows, kept row-major.
__device__ __forceinline__ void load_w_cols(__nv_bfloat16* dst, const __nv_bfloat16* wl, int c0, int tid) {
    for (int i = tid; i < C * (KS / VEC); i += THREADS) {
        const int r = i / (KS / VEC);
        const int c = (i % (KS / VEC)) * VEC;
        cp_async16(dst + r * LDB + c, wl + size_t(r) * C + c0 + c);
    }
}

struct ResTags {
    int v[MAX_LAYERS];
};

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[FR][FC] = A(64 x 512, shared, row-major) @ op(W[l]) for this warp's
// slab. `backward` selects op(W) = W^T (column slabs, column-major fragment
// loads) instead of W (row slabs). Ends with a block barrier: every warp is
// done reading A and the stages.
__device__ __forceinline__ void block_gemm(AccFrag (&acc)[FR][FC], const __nv_bfloat16* a_src,
                                           const __nv_bfloat16* wl, __nv_bfloat16* wst0,
                                           __nv_bfloat16* wst1, bool backward, int wr, int wc, int tid) {
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < FC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    if (backward) load_w_cols(wst0, wl, 0, tid); else load_w_rows(wst0, wl, 0, tid);
    cp_async_commit();
    for (int s = 0; s < C / KS; ++s) {
        if (s + 1 < C / KS) {
            __nv_bfloat16* next = (s & 1) ? wst0 : wst1;
            if (backward) load_w_cols(next, wl, (s + 1) * KS, tid); else load_w_rows(next, wl, (s + 1) * KS, tid);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const __nv_bfloat16* wst = (s & 1) ? wst1 : wst0;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FR];
#pragma unroll
            for (int i = 0; i < FR; ++i)
                wmma::load_matrix_sync(af[i], a_src + (wr + 16 * i) * LDS + s * KS + kk, LDS);
            if (backward) {
                // B(c, k) = W[k][c0 + c]: column-major over the row-major slab
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[FC];
#pragma unroll
                for (int j = 0; j < FC; ++j)
                    wmma::load_matrix_sync(bf[j], wst + (wc + 16 * j) * LDB + kk, LDB);
#pragma unroll
                for (int i = 0; i < FR; ++i)
#pragma unroll
                    for (int j = 0; j < FC; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
            } else {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FC];
#pragma unroll
                for (int j = 0; j < FC; ++j)
                    wmma::load_matrix_sync(bf[j], wst + kk * LDF + wc + 16 * j, LDF);
#pragma unroll
                for (int i = 0; i < FR; ++i)
#pragma unroll
                    for (int j = 0; j < FC; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
            }
        }
        // all warps are done with this stage (refilled next iteration)
        // and, after the last stage, with A (overwritten in place after)
        __syncthreads();
    }
}

// Copy the tile's valid rows of a shared buffer to a (rows, 512) global array.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int B, int tid) {
    for (int i = tid; i < BM * (C / VEC); i += THREADS) {
        const int r = i / (C / VEC);
        const int c = (i % (C / VEC)) * VEC;
        if (row0 + r < B) {
            *reinterpret_cast<uint4*>(dst + size_t(row0 + r) * C + c) =
                *reinterpret_cast<const uint4*>(src + r * LDS + c);
        }
    }
}

// Load the tile's rows of a (B, 512) global array; rows past B are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int B, int tid) {
    for (int i = tid; i < BM * (C / VEC); i += THREADS) {
        const int r = i / (C / VEC);
        const int c = (i % (C / VEC)) * VEC;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < B) v = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * C + c);
        *reinterpret_cast<uint4*>(dst + r * LDS + c) = v;
    }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_head_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ g_in,
                      __nv_bfloat16* __restrict__ dx,
                      __nv_bfloat16* __restrict__ gpre,
                      __nv_bfloat16* __restrict__ acts_in,
                      uint8_t* __restrict__ masks,
                      int B, int L, ResTags tags) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* buf1 = reinterpret_cast<__nv_bfloat16*>(smem + ACT_BYTES);
    __nv_bfloat16* wst0 = reinterpret_cast<__nv_bfloat16*>(smem + 2 * ACT_BYTES);
    __nv_bfloat16* wst1 = reinterpret_cast<__nv_bfloat16*>(smem + 2 * ACT_BYTES + WST_BYTES);
    float* scratch_all = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + 2 * WST_BYTES);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row0 = blockIdx.x * BM;
    const int wr = (warp / (C / WARP_COLS)) * WARP_ROWS;  // 0 or 32
    const int wc = (warp % (C / WARP_COLS)) * WARP_COLS;  // 0..448
    float* scratch = scratch_all + warp * 256;
    // lane -> (row, 8 consecutive columns) of a 16x16 fragment
    const int fr = lane / 2;
    const int fc0 = (lane % 2) * 8;
    const size_t plane = size_t(B) * C;  // one layer of gpre / acts_in

    // ---- 1. forward recompute: buf0 = residual stream, buf1 = working h ----
    __nv_bfloat16* res = buf0;
    __nv_bfloat16* hbuf = buf1;
    load_tile(res, x, row0, B, tid);
    __syncthreads();
    bool h_is_res = true;
    for (int l = 0; l < L; ++l) {
        const __nv_bfloat16* a_src = h_is_res ? res : hbuf;
        store_tile(acts_in + l * plane, a_src, row0, B, tid);
        AccFrag acc[FR][FC];
        block_gemm(acc, a_src, w + size_t(l) * C * C, wst0, wst1, false, wr, wc, tid);

        const bool is_res = tags.v[l] != 0;
        __nv_bfloat16* dst = is_res ? res : hbuf;
        const float* bl = bias + size_t(l) * C;
#pragma unroll
        for (int i = 0; i < FR; ++i) {
#pragma unroll
            for (int j = 0; j < FC; ++j) {
                wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
                __syncwarp();
                const int r = wr + 16 * i + fr;
                const int c = wc + 16 * j + fc0;
                unsigned bits = 0;
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float pre = scratch[fr * 16 + fc0 + e] + bl[c + e];
                    bits |= (pre > 0.0f ? 1u : 0u) << e;
                    const __nv_bfloat16 a = __float2bfloat16_rn(pre > 0.0f ? pre : 0.0f);
                    __nv_bfloat16* p = dst + r * LDS + c + e;
                    if (is_res) {
                        *p = __float2bfloat16_rn(__bfloat162float(*p) + __bfloat162float(a));
                    } else {
                        *p = a;
                    }
                }
                if (row0 + r < B) masks[(size_t(l) * B + row0 + r) * MASK_BYTES + c / 8] = uint8_t(bits);
                __syncwarp();
            }
        }
        h_is_res = is_res;
        __syncthreads();
    }

    // ---- 2. walk back: buf0 = g, buf1 = g_res -------------------------------
    __nv_bfloat16* gbuf = buf0;
    __nv_bfloat16* gres = buf1;
    load_tile(gbuf, g_in, row0, B, tid);
    for (int i = tid; i < BM * LDS / 2; i += THREADS) reinterpret_cast<__nv_bfloat162*>(gres)[i] = __float2bfloat162_rn(0.0f);
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
        const bool is_res = tags.v[l] != 0;
        // elementwise: the skip path joins at a residual layer, then the mask
        for (int i = tid; i < BM * (C / VEC); i += THREADS) {
            const int r = i / (C / VEC);
            const int c = (i % (C / VEC)) * VEC;
            __nv_bfloat16* gp = gbuf + r * LDS + c;
            __nv_bfloat16* rp = gres + r * LDS + c;
            const bool valid = row0 + r < B;
            const unsigned bits = valid ? masks[(size_t(l) * B + row0 + r) * MASK_BYTES + c / 8] : 0u;
            __align__(16) __nv_bfloat16 out[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                __nv_bfloat16 gv = gp[e];
                if (is_res) {
                    gv = __float2bfloat16_rn(__bfloat162float(gv) + __bfloat162float(rp[e]));
                    rp[e] = gv;
                }
                out[e] = ((bits >> e) & 1u) ? gv : __float2bfloat16_rn(0.0f);
                gp[e] = out[e];
            }
            if (valid) {
                *reinterpret_cast<uint4*>(gpre + l * plane + size_t(row0 + r) * C + c) =
                    *reinterpret_cast<const uint4*>(out);
            }
        }
        __syncthreads();

        AccFrag acc[FR][FC];
        block_gemm(acc, gbuf, w + size_t(l) * C * C, wst0, wst1, true, wr, wc, tid);
        // g = bf16(gpre @ W^T), in place: every warp has finished reading gpre
#pragma unroll
        for (int i = 0; i < FR; ++i) {
#pragma unroll
            for (int j = 0; j < FC; ++j) {
                wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
                __syncwarp();
                const int r = wr + 16 * i + fr;
                const int c = wc + 16 * j + fc0;
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    gbuf[r * LDS + c + e] = __float2bfloat16_rn(scratch[fr * 16 + fc0 + e]);
                }
                __syncwarp();
            }
        }
        __syncthreads();
    }

    // ---- 3. dx = bf16(g + g_res) -----------------------------------------
    for (int i = tid; i < BM * (C / VEC); i += THREADS) {
        const int r = i / (C / VEC);
        const int c = (i % (C / VEC)) * VEC;
        if (row0 + r < B) {
            __align__(16) __nv_bfloat16 out[VEC];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
                out[e] = __float2bfloat16_rn(__bfloat162float(gbuf[r * LDS + c + e]) +
                                             __bfloat162float(gres[r * LDS + c + e]));
            }
            *reinterpret_cast<uint4*>(dx + size_t(row0 + r) * C + c) = *reinterpret_cast<const uint4*>(out);
        }
    }
}

}  // namespace

extern "C" {

// x, g, dx: (B, 512) bf16; w: (L, 512, 512) bf16; b: (L, 512) f32; gpre,
// acts_in: (L, B, 512) bf16; masks: (L, B, 64) uint8 scratch; res_after:
// host array of L ints. Launches on `stream` and returns cudaGetLastError().
int fused_head_bwd(const void* x, const void* w, const void* b, const void* g,
                   const int* res_after, void* dx, void* gpre, void* acts_in,
                   void* masks, int B, int L, cudaStream_t stream) {
    if (B < 0 || L < 1 || L > MAX_LAYERS || res_after == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    ResTags tags;
    for (int l = 0; l < MAX_LAYERS; ++l) tags.v[l] = l < L ? res_after[l] : 0;
    cudaError_t err = cudaFuncSetAttribute(
        fused_head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (B + BM - 1) / BM;
    fused_head_bwd_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(gpre),
        static_cast<__nv_bfloat16*>(acts_in), static_cast<uint8_t*>(masks), B, L, tags);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
