// One window of value-transfer blocks in one launch, for Hopper (sm_90a).
//
// Replaces the reference's jitted device program
//   coreth_tpu/replay/engine.py:245 _transfer_window
//   (with _step_core:209, _transfer_step:282, _slot_step:224,
//    _gather_fetch:196 and the ops/u256.py limb chains).
// It gathers the window-local accounts and slots, runs the K blocks in
// order (each block's nonce-sequence and solvency checks, per-account
// debits / required balance / credits plus the coinbase fee, per-slot
// token debits and credits), writes one fetch row block per block and
// scatters the locals back.  The plain PyTorch version it is held
// against is engine._transfer_window_plain; both follow the reference
// bit for bit, including out-of-bounds pad gids (gather zeros, drop on
// scatter) and blocks whose ok flag is 0 (their state still applies,
// sub wrapping mod 2^256, and later blocks run on top).
//
// Design: blocks depend on each other in sequence, so ONE thread block
// loops over the K blocks with __syncthreads() between phases, working
// on window-local tables in device memory.  Per block it visits only
// the rows the block's txs touch (senders, recipients, coinbase, token
// slots) instead of all L locals: integer adds are associative, so
// accumulating with atomics in any order gives the reference's sums
// exactly, and rows no tx touches keep their values under the reference
// too.  Sums accumulate in uint32 limbs and normalize once (see
// transfer_block.cuh, which holds the per-block body and the u256 limb
// chains, shared with the sharded window kernel K8).
//
// Bound: bytes — each table, the packed txs and the fetch rows read or
// written once, ~15 MB at main-path shapes (~4 us at 3.35 TB/s); a few
// hundred integer ops per tx are far below that.  This simple design
// is far from the bound: it waits on the chain of dependent phases (4
// barriers per block) and on device-memory and atomic latency inside
// one SM.

#include <cstdint>
#include <cuda_runtime.h>

#include "transfer_block.cuh"

namespace {

using tw::ACCW;
using tw::COLS;
using tw::LIMBS;
using tw::SACC;
using tw::in_range;

__global__ void __launch_bounds__(1024) transfer_window_kernel(
    int* __restrict__ bal, int* __restrict__ non, int* __restrict__ sv,
    int cap, int scap, const int* __restrict__ acct_gids, int L,
    const int* __restrict__ slot_gids, int SL, const int* __restrict__ txds,
    int K, int pad, const int* __restrict__ t_idxs, int t_pad,
    const int* __restrict__ s_idxs, int s_pad, int* __restrict__ lb,
    int* __restrict__ ln, int* __restrict__ ls, unsigned* __restrict__ acc,
    int* __restrict__ stamp, unsigned* __restrict__ sacc,
    int* __restrict__ sstamp, int* __restrict__ fetches) {
  __shared__ int bad;
  const int tid = threadIdx.x, nt = blockDim.x;

  // gather the window-local rows; out-of-bounds gids read zeros
  for (int e = tid; e < L * LIMBS; e += nt) {
    int g = acct_gids[e / LIMBS];
    lb[e] = in_range(g, cap) ? bal[(int64_t)g * LIMBS + e % LIMBS] : 0;
  }
  for (int l = tid; l < L; l += nt) {
    int g = acct_gids[l];
    ln[l] = in_range(g, cap) ? non[g] : 0;
    stamp[l] = -1;
  }
  for (int e = tid; e < SL * LIMBS; e += nt) {
    int g = slot_gids[e / LIMBS];
    ls[e] = in_range(g, scap) ? sv[(int64_t)g * LIMBS + e % LIMBS] : 0;
  }
  for (int l = tid; l < SL; l += nt) sstamp[l] = -1;
  __syncthreads();

  auto sum_a = [&](int r, int c) { return acc[(int64_t)r * ACCW + c]; };
  auto sum_s = [&](int r, int c) { return sacc[(int64_t)r * SACC + c]; };
  const int frows = t_pad + s_pad + 1;
  for (int k = 0; k < K; ++k) {
    const int* txd = txds + (int64_t)k * pad * COLS;
    if (tid == 0) bad = 0;
    tw::zero_touched(txd, pad, L, SL, acc, sacc);
    __syncthreads();
    tw::accumulate(txd, 0, pad, L, SL, ln, acc, sacc, &bad);
    __syncthreads();
    tw::apply_touched(txd, pad, k, L, SL, lb, ln, ls, stamp, sstamp, sum_a,
                      sum_s, &bad);
    __syncthreads();
    tw::write_fetch(fetches + (int64_t)k * frows * tw::FW,
                    t_idxs + (int64_t)k * t_pad, t_pad,
                    s_idxs + (int64_t)k * s_pad, s_pad, lb, ln, ls, L, SL,
                    bad == 0);
    __syncthreads();
  }

  // scatter the locals back; out-of-bounds gids drop
  for (int e = tid; e < L * LIMBS; e += nt) {
    int g = acct_gids[e / LIMBS];
    if (in_range(g, cap)) bal[(int64_t)g * LIMBS + e % LIMBS] = lb[e];
  }
  for (int l = tid; l < L; l += nt) {
    int g = acct_gids[l];
    if (in_range(g, cap)) non[g] = ln[l];
  }
  for (int e = tid; e < SL * LIMBS; e += nt) {
    int g = slot_gids[e / LIMBS];
    if (in_range(g, scap)) sv[(int64_t)g * LIMBS + e % LIMBS] = ls[e];
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  bal/non/sv are updated
// in place; the wrapper hands in clones of the engine's tables.  The
// scratch (lb, ln, ls, acc [L][ACCW], stamp, sacc, sstamp) is allocated
// by the wrapper.  Returns cudaGetLastError().
extern "C" int transfer_window_launch(
    void* bal, void* non, void* sv, int cap, int scap, const void* acct_gids,
    int L, const void* slot_gids, int SL, const void* txds, int K, int pad,
    const void* t_idxs, int t_pad, const void* s_idxs, int s_pad, void* lb,
    void* ln, void* ls, void* acc, void* stamp, void* sacc, void* sstamp,
    void* fetches, void* stream) {
  transfer_window_kernel<<<1, 1024, 0, (cudaStream_t)stream>>>(
      (int*)bal, (int*)non, (int*)sv, cap, scap, (const int*)acct_gids, L,
      (const int*)slot_gids, SL, (const int*)txds, K, pad,
      (const int*)t_idxs, t_pad, (const int*)s_idxs, s_pad, (int*)lb,
      (int*)ln, (int*)ls, (unsigned*)acc, (int*)stamp, (unsigned*)sacc,
      (int*)sstamp, (int*)fetches);
  return (int)cudaGetLastError();
}
