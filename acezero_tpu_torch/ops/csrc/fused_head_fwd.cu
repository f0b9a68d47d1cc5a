// Fused scene-coordinate head chain, forward, for Hopper (sm_90a).
//
// Replaces acezero_tpu/ops/fused_head.py::_forward_kernel (launched by
// _run_forward, chain in _chain_forward): L layers of
//     a = bf16(relu(h @ W[l] + b[l]))        (f32 accumulation)
// with a bf16 residual add after every layer tagged in res_after
// (res = res + a; h = res), otherwise h = a. The chain starts from
// h = res = x. fc3 and the homogeneous epilogue stay outside.
//
// Shapes: x (B, 512) bf16, W (L, 512, 512) bf16 in (cin, cout) layout,
// b (L, 512) f32, out (B, 512) bf16. Any B (the ragged last tile is
// masked), any L <= 64 and any res_after.
//
// Bound on an H100 SXM at the registration shape (B = 307,200 rows per
// 64-frame chunk, L = 8): 2 * B * 512^2 * L = 1.29 TFLOP, i.e. about
// 1.30 ms at the 989 TFLOP/s bf16 dense peak, against about 0.19 ms to read
// x and write out at 3.35 TB/s (W is 4 MB and stays in L2). So the kernel is
// compute-bound as long as the activations stay on chip across all L layers.
//
// Design: one block of 16 warps owns a 64-row tile for the whole chain. The
// tile's working activation h and its residual stream live in shared memory
// (two 64 x 512 bf16 buffers, rows padded against bank conflicts), so
// device memory sees x once and out once. Each layer's W streams through
// shared memory in 32-row stages, double-buffered with cp.async so the next
// stage loads while the current one feeds the tensor cores; all 16 warps
// share each stage. Each warp computes a 32 x 64 output slab with WMMA bf16
// 16x16x16 products and f32 accumulators in registers. The epilogue (bias,
// ReLU, bf16 rounding, residual add) runs per 16x16 fragment through a small
// per-warp f32 scratch, after a block barrier, in place: all warps have
// finished reading h by then. Still far from the bound: WMMA (mma.sync)
// instead of wgmma, one block per SM, no TMA; those are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int C = 512;          // head width
constexpr int BM = 64;          // rows per block
constexpr int LDS = C + 8;      // padded shared-memory row (elements)
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int WARP_ROWS = 32;   // rows per warp slab
constexpr int WARP_COLS = 64;   // cols per warp slab
constexpr int FR = WARP_ROWS / 16;
constexpr int FC = WARP_COLS / 16;
constexpr int MAX_LAYERS = 64;

constexpr int KS = 32;          // W rows per shared-memory stage
constexpr size_t ACT_BYTES = size_t(BM) * LDS * sizeof(__nv_bfloat16);
constexpr size_t WST_BYTES = size_t(KS) * LDS * sizeof(__nv_bfloat16);
constexpr size_t SCRATCH_BYTES = size_t(WARPS) * 16 * 16 * sizeof(float);
constexpr size_t SMEM_BYTES = 2 * ACT_BYTES + 2 * WST_BYTES + SCRATCH_BYTES;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr) {
    const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy W rows [k0, k0 + KS) of one layer into a shared-memory stage.
__device__ __forceinline__ void load_w_stage(__nv_bfloat16* dst, const __nv_bfloat16* wl, int k0, int tid) {
    for (int i = tid; i < KS * (C / 8); i += THREADS) {
        const int r = i / (C / 8);
        const int c = (i % (C / 8)) * 8;
        cp_async16(dst + r * LDS + c, wl + size_t(k0 + r) * C + c);
    }
}

struct ResTags {
    int v[MAX_LAYERS];
};

__global__ void __launch_bounds__(THREADS, 1)
fused_head_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out,
                      int B, int L, ResTags tags) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* res = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* hbuf = reinterpret_cast<__nv_bfloat16*>(smem + ACT_BYTES);
    __nv_bfloat16* wst0 = reinterpret_cast<__nv_bfloat16*>(smem + 2 * ACT_BYTES);
    __nv_bfloat16* wst1 = reinterpret_cast<__nv_bfloat16*>(smem + 2 * ACT_BYTES + WST_BYTES);
    float* scratch_all = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + 2 * WST_BYTES);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int row0 = blockIdx.x * BM;

    // Load the x tile into the residual buffer (16 bytes per thread-step);
    // rows past B are zero and never stored.
    constexpr int VEC = 8;  // bf16 per uint4
    for (int i = tid; i < BM * (C / VEC); i += THREADS) {
        const int r = i / (C / VEC);
        const int c = (i % (C / VEC)) * VEC;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < B) {
            v = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * C + c);
        }
        *reinterpret_cast<uint4*>(res + r * LDS + c) = v;
    }
    __syncthreads();

    const int wr = (warp / (C / WARP_COLS)) * WARP_ROWS;  // 0 or 32
    const int wc = (warp % (C / WARP_COLS)) * WARP_COLS;  // 0..448
    float* scratch = scratch_all + warp * 256;
    bool h_is_res = true;

    for (int l = 0; l < L; ++l) {
        const __nv_bfloat16* a_src = h_is_res ? res : hbuf;
        const __nv_bfloat16* wl = w + size_t(l) * C * C;

        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FR][FC];
#pragma unroll
        for (int i = 0; i < FR; ++i)
#pragma unroll
            for (int j = 0; j < FC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

        load_w_stage(wst0, wl, 0, tid);
        cp_async_commit();
        for (int s = 0; s < C / KS; ++s) {
            if (s + 1 < C / KS) {
                load_w_stage((s & 1) ? wst0 : wst1, wl, (s + 1) * KS, tid);
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
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FC];
#pragma unroll
                for (int i = 0; i < FR; ++i)
                    wmma::load_matrix_sync(af[i], a_src + (wr + 16 * i) * LDS + s * KS + kk, LDS);
#pragma unroll
                for (int j = 0; j < FC; ++j)
                    wmma::load_matrix_sync(bf[j], wst + kk * LDS + wc + 16 * j, LDS);
#pragma unroll
                for (int i = 0; i < FR; ++i)
#pragma unroll
                    for (int j = 0; j < FC; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
            }
            // all warps are done with this stage (refilled next iteration)
            // and, after the last stage, with h (overwritten in place below)
            __syncthreads();
        }

        const bool is_res = tags.v[l] != 0;
        __nv_bfloat16* dst = is_res ? res : hbuf;
        const float* bl = bias + size_t(l) * C;
        // lane -> (row, 8 consecutive columns) of a 16x16 fragment
        const int fr = lane / 2;
        const int fc0 = (lane % 2) * 8;
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
                    const float pre = scratch[fr * 16 + fc0 + e] + bl[c + e];
                    const __nv_bfloat16 a = __float2bfloat16_rn(pre > 0.0f ? pre : 0.0f);
                    __nv_bfloat16* p = dst + r * LDS + c + e;
                    if (is_res) {
                        *p = __float2bfloat16_rn(__bfloat162float(*p) + __bfloat162float(a));
                    } else {
                        *p = a;
                    }
                }
                __syncwarp();
            }
        }
        h_is_res = is_res;
        __syncthreads();
    }

    const __nv_bfloat16* h = h_is_res ? res : hbuf;
    for (int i = tid; i < BM * (C / VEC); i += THREADS) {
        const int r = i / (C / VEC);
        const int c = (i % (C / VEC)) * VEC;
        if (row0 + r < B) {
            *reinterpret_cast<uint4*>(out + size_t(row0 + r) * C + c) =
                *reinterpret_cast<const uint4*>(h + r * LDS + c);
        }
    }
}

}  // namespace

extern "C" {

// x, w, out: bf16 device pointers; b: f32 device pointer; res_after: host
// array of L ints. Launches on `stream` and returns cudaGetLastError().
int fused_head_fwd(const void* x, const void* w, const void* b,
                   const int* res_after, void* out, int B, int L,
                   cudaStream_t stream) {
    if (B < 0 || L < 1 || L > MAX_LAYERS || res_after == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    ResTags tags;
    for (int l = 0; l < MAX_LAYERS; ++l) tags.v[l] = l < L ? res_after[l] : 0;
    cudaError_t err = cudaFuncSetAttribute(
        fused_head_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (B + BM - 1) / BM;
    fused_head_fwd_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), B, L, tags);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
