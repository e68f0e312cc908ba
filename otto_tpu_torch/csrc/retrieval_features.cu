// K7: retrieval's Stage E after its transport sort, in one launch. For
// every session s and candidate slot c < Cmax it writes cand[s, c],
// ts_order[s, c] and the 104 float32 features feats[s, c, :] in
// FEATURE_NAMES order (engine/retrieval.py), from the slots' sort keys
// `pk` [S, C], the C kept lanes of the Stage D groupby's columns (moved by
// K1), the session stats, the popularity ranks and the embeddings. Slots
// c >= C are padding: cand -1, ts_order 999, features 0.
//
// Replaces no Pallas kernel: otto_tpu runs Stage E as XLA ops fused under
// jit. The port ran it as ~600 eager PyTorch launches a batch (casts,
// wheres, divisions, a [S, C, D] gather and an einsum for one dot product
// a lane, a 104-way stack, the padding), whose host time set pass B's pace.
// Its plain twin is `engine/retrieval.py::_features_program`, which a CPU
// batch runs.
//
// Rounding: the twin's every float32 operation, as PyTorch runs it on the
// card, is one rounding here too: __fdiv_rn / __fmul_rn / __fadd_rn /
// __frcp_rn, which nvcc never contracts into an FMA, int -> float with
// round-to-nearest and float -> int toward zero (saturating), int32
// arithmetic wrapping as PyTorch's does. PyTorch divides a tensor by a
// Python number as a product with the number's float32 reciprocal and
// computes `10.0 / x` as reciprocal(x) * 10, and so does this kernel. So
// every feature is bit-equal to the twin on the card but the two that take
// the 100-wide dot product and norms (cos_sim_ses_aid, eucl_dist_ses_aid):
// those sum in four strands (d mod 4) in increasing d, then (0 + 1) + (2 +
// 3), with FMAs, where the twin sums in cuBLAS's and its norm's orders.
// The kernel's sums do not depend on the batch.
//
// What bounds it on the card: bytes. A lane reads its 82 column words and
// its sort key (~332 B), an item embedding row (400 B at D = 100) and its
// popularity row (12 B of 24), and writes 104 features, cand and ts_order
// (424 B): ~1.27 GB at 2,048 sessions x 512 slots, 0.38 ms at 3.35 TB/s.
// The design:
//   * One block of TILE threads a tile of TILE consecutive slots of one
//     session, one thread a slot: each column word is a coalesced load
//     across the warp; the session's stats and embedding are read once a
//     block (the embedding into shared memory).
//   * A thread computes its slot's features into its row of a shared
//     tile at an odd stride (ROW = 105 words: conflict-free across the
//     warp), then the block stores the tile's contiguous TILE x 104 floats
//     with coalesced 4-byte stores. The [S, C, D] candidate vectors never
//     exist: each thread reads its item's row with 16-byte loads when the
//     table allows.
//   * Invalid slots (an empty sort key or no candidate) read nothing but
//     their session's stats.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                // slots a block, one thread each
constexpr int SENT = 2147483647;         // the reducers' min identity, an empty key
constexpr int NEG_SENT = -2147483647;    // the max identity
constexpr int NUL = -1;                  // the features' null
constexpr int MAX_D = 1024;              // embedding width a block stages

// The columns a launch reads, in ops/kernels/retrieval_features.py COLUMNS
// order (tests/test_torch_retrieval_features.py holds the two equal). A
// run of columns named alike is indexed from its first.
enum Column : int {
  C_cand, C_ts_order,
  C_n_uniq_aid, C_n_uniq_aid_clicks, C_n_uniq_aid_carts, C_n_uniq_aid_orders,
  C_n_aid, C_n_aid_clicks, C_n_aid_carts, C_n_aid_orders,
  C_max_ts_aid, C_max_ts_aid_clicks, C_max_ts_aid_carts, C_max_ts_aid_orders,
  C_sum_rel_max_ts_aid, C_sum_rel_max_ts_aid_orders, C_cnt_max_ts_aid_orders,
  C_ts_order_aid_rel, C_ts_order_aid_clicks, C_ts_order_aid_carts, C_ts_order_aid_orders,
  C_rank_by_n_aid, C_sum_rel_pos,
  C_cov0_count, C_cov0_num_count_pop, C_cov0_num_perc_pop, C_cov0_num_count_rel,
  C_cov0_num_rank,
  C_cov1_count, C_cov1_num_count_pop, C_cov1_num_perc_pop, C_cov1_num_count_rel,
  C_cov1_num_rank,
  C_cov2_count, C_cov2_num_count_pop, C_cov2_num_perc_pop, C_cov2_num_count_rel,
  C_cov2_num_rank,
  C_cov3_count, C_cov3_num_count_pop, C_cov3_num_perc_pop, C_cov3_num_count_rel,
  C_cov3_num_rank,
  C_cov4_count, C_cov4_num_count_pop, C_cov4_num_perc_pop, C_cov4_num_count_rel,
  C_cov4_num_rank,
  C_w2v_all_n, C_w2v_all_sum_rank, C_w2v_all_best_rank, C_w2v_all_sum_dist,
  C_w2v_12_n, C_w2v_12_sum_rank, C_w2v_12_best_rank, C_w2v_12_sum_dist,
  C_slf_present, C_slf_n, C_slf_n_clicks, C_slf_n_carts, C_slf_n_orders,
  C_slf_rank_by_n, C_slf_rank_by_n_carts, C_slf_rank_by_n_orders,
  C_slf_max_ts, C_slf_max_ts_clicks, C_slf_max_ts_carts, C_slf_max_ts_orders,
  C_slf_ts_rel_pos, C_slf_ts_order, C_slf_ts_order_rel, C_slf_ts_order_clicks,
  C_slf_ts_order_carts, C_slf_ts_order_orders, C_slf_left_in_cart,
  C_pop_0, C_pop_1, C_pop_2, C_pop_3, C_pop_4, C_pop_5, C_pop_present,
  NCOLS
};

// The session stats, in retrieval_features.py STATS order.
enum Stat : int {
  S_n_events, S_n_aids, S_n_clicks, S_n_carts, S_n_orders, S_duration,
  S_only_orders, S_max_ts, S_min_ts,
  NSTATS
};

// The features, in engine/retrieval.py FEATURE_NAMES order (the test
// holds the two equal).
enum Feature : int {
  F_n_events_session, F_n_aids_session, F_n_clicks_session, F_n_carts_session,
  F_n_orders_session, F_duration_session, F_only_orders_session, F_slf_n, F_slf_n_clicks,
  F_slf_n_carts, F_slf_n_orders, F_slf_rank_by_n, F_slf_rank_by_n_carts,
  F_slf_rank_by_n_orders, F_slf_since_ts, F_slf_since_ts_clicks, F_slf_since_ts_carts,
  F_slf_since_ts_orders, F_slf_ts_rel_pos_in_session, F_slf_ts_order, F_slf_ts_order_rel,
  F_slf_ts_order_clicks, F_slf_ts_order_carts, F_slf_ts_order_orders, F_slf_left_in_cart,
  F_n_uniq_aid, F_n_uniq_aid_clicks, F_n_uniq_aid_carts, F_n_uniq_aid_orders, F_n_aid,
  F_n_aid_clicks, F_n_aid_carts, F_n_aid_orders, F_since_ts_aid, F_since_ts_aid_clicks,
  F_since_ts_aid_carts, F_since_ts_aid_orders, F_since_session_start_ts_aid,
  F_since_session_start_ts_aid_orders, F_rel_pos_max_ts_aid_in_session,
  F_rel_pos_mean_max_ts_aid_in_session, F_rel_pos_mean_max_ts_aid_orders_in_session,
  F_ts_order_aid, F_ts_order_aid_rel, F_ts_order_aid_clicks, F_ts_order_aid_carts,
  F_ts_order_aid_orders, F_ts_aid_rel_pos_in_session, F_rank_by_n_aid,
  F_click_to_click_count, F_click_to_click_count_pop, F_click_to_click_perc_pop,
  F_click_to_click_rank, F_click_to_click_count_rel, F_click_to_cart_or_buy_count,
  F_click_to_cart_or_buy_count_pop, F_click_to_cart_or_buy_perc_pop,
  F_click_to_cart_or_buy_rank, F_click_to_cart_or_buy_count_rel, F_cart_to_cart_count,
  F_cart_to_cart_count_pop, F_cart_to_cart_perc_pop, F_cart_to_cart_rank,
  F_cart_to_cart_count_rel, F_cart_to_buy_count, F_cart_to_buy_count_pop,
  F_cart_to_buy_perc_pop, F_cart_to_buy_rank, F_cart_to_buy_count_rel, F_buy_to_buy_count,
  F_buy_to_buy_count_pop, F_buy_to_buy_perc_pop, F_buy_to_buy_rank,
  F_buy_to_buy_count_rel, F_n_w2vec_all, F_dist_w2vec_all, F_rank_w2vec_all,
  F_best_rank_w2vec_all, F_n_w2vec_1_2, F_dist_w2vec_1_2, F_rank_w2vec_1_2,
  F_best_rank_w2vec_1_2, F_src_any, F_src_self, F_src_click_to_click,
  F_src_click_to_cart_or_buy, F_src_cart_to_cart, F_src_cart_to_buy, F_src_buy_to_buy,
  F_src_w2vec_all, F_src_w2vec_1_2, F_src_pop_cl50, F_rank_clicks_cl50, F_rank_carts_cl50,
  F_rank_orders_cl50, F_rank_clicks_7d_cl50, F_rank_carts_7d_cl50, F_rank_orders_7d_cl50,
  F_rank_clicks_cl1, F_rank_carts_cl1, F_rank_orders_cl1, F_cos_sim_ses_aid,
  F_eucl_dist_ses_aid, F_heur_score,
  NFEAT
};

constexpr int ROW = NFEAT + 1;           // a slot's staged row, odd: no bank conflicts
constexpr int CO = C_cov1_count - C_cov0_count;            // columns a co-visitation table
constexpr int FO = F_click_to_cart_or_buy_count - F_click_to_click_count;
constexpr int WC = C_w2v_12_n - C_w2v_all_n;               // columns a w2vec model
constexpr int WF = F_n_w2vec_1_2 - F_n_w2vec_all;
static_assert(NFEAT == 104 && ROW % 2 == 1, "104 features at an odd stride");
static_assert(CO == 5 && FO == 5 && WC == 4 && WF == 4, "column and feature runs");

// the column pointers, by value (float columns are read as their words)
struct Inputs {
  const int32_t* col[NCOLS];
  const int32_t* stat[NSTATS];
};

__device__ __forceinline__ int wsub(int a, int b) {   // int32 a - b, wrapping
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ float i2f(int x) { return __int2float_rn(x); }
__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }
__device__ __forceinline__ float nul_to(int x, int ident) {   // _null_to(x, ident, -1)
  return i2f(x == ident ? NUL : x);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {  // torch.clamp(min=): NaN stays
  return x < lo ? lo : x;
}

template <bool VEC>
__global__ void __launch_bounds__(TILE)
retrieval_features_kernel(const __grid_constant__ Inputs in, const int32_t* __restrict__ pk,
                          long long ld_pk, const int32_t* __restrict__ pop_cl1, int a_pop,
                          int k_pop, const float* __restrict__ aid_emb, int a_emb,
                          const float* __restrict__ ses_emb, int D,
                          int32_t* __restrict__ cand_out, int32_t* __restrict__ ts_out,
                          float* __restrict__ feats, int C, int Cmax) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                    // [TILE][ROW]
  float* ses = smem + TILE * ROW;        // [D], 16-byte aligned (TILE * ROW * 4 is)
  const int tiles = (Cmax + TILE - 1) / TILE;
  const int s = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - s * tiles) * TILE;
  const int c = c0 + threadIdx.x;
  for (int d = threadIdx.x; d < D; d += TILE) ses[d] = __ldg(ses_emb + static_cast<int64_t>(s) * D + d);
  __syncthreads();

  float* o = tile + threadIdx.x * ROW;
  if (c < Cmax) {
    const int64_t out_at = static_cast<int64_t>(s) * Cmax + c;
    const int64_t at = static_cast<int64_t>(s) * C + c;
    const bool slot_ok = c < C && __ldg(pk + s * ld_pk + c) != SENT;
    const int cand = slot_ok ? __ldg(in.col[C_cand] + at) : -1;
    const int ts_c = slot_ok ? __ldg(in.col[C_ts_order] + at) : SENT;
    const bool valid = cand >= 0;
    cand_out[out_at] = cand;
    ts_out[out_at] = min(max(ts_c, 0), 999);
    if (c >= C) {
      for (int k = 0; k < NFEAT; ++k) o[k] = 0.0f;   // the padding slots
    } else {
      // session-level: stat * valid, so an invalid slot reads +-0
      const float vf = valid ? 1.0f : 0.0f;
      for (int k = 0; k <= S_only_orders; ++k) {
        o[F_n_events_session + k] = __fmul_rn(i2f(__ldg(in.stat[k] + s)), vf);
      }
      if (!valid) {
        for (int k = F_slf_n; k < NFEAT; ++k) o[k] = -1.0f;
        for (int k = F_src_any; k <= F_src_pop_cl50; ++k) o[k] = 0.0f;
        o[F_cos_sim_ses_aid] = 0.0f;
        o[F_heur_score] = 0.0f;
      } else {
        auto v = [&](int k) { return __ldg(in.col[k] + at); };
        const int max_ts = __ldg(in.stat[S_max_ts] + s);
        const int min_ts = __ldg(in.stat[S_min_ts] + s);
        const float span1 = i2f(wsub(wsub(max_ts, min_ts), -1));   // max - min + 1

        // self
        for (int k = 0; k < 4; ++k) o[F_slf_n + k] = i2f(v(C_slf_n + k));
        for (int k = 0; k < 3; ++k) o[F_slf_rank_by_n + k] = nul_to(v(C_slf_rank_by_n + k), SENT);
        for (int k = 0; k < 4; ++k) {
          const int mts = v(C_slf_max_ts + k);
          o[F_slf_since_ts + k] = i2f(mts == NEG_SENT ? NUL : wsub(max_ts, mts));
        }
        o[F_slf_ts_rel_pos_in_session] = nul_to(v(C_slf_ts_rel_pos), SENT);
        for (int k = 0; k < 5; ++k) o[F_slf_ts_order + k] = nul_to(v(C_slf_ts_order + k), SENT);
        o[F_slf_left_in_cart] = i2f(v(C_slf_left_in_cart));

        // aggregates
        const int n_uniq = v(C_n_uniq_aid);
        const float n_uniq_f = i2f(max(n_uniq, 1));
        for (int k = 0; k < 4; ++k) o[F_n_uniq_aid + k] = i2f(v(C_n_uniq_aid + k));
        for (int k = 0; k < 4; ++k) o[F_n_aid + k] = i2f(v(C_n_aid + k));
        for (int k = 0; k < 4; ++k) {
          const int mts = v(C_max_ts_aid + k);
          o[F_since_ts_aid + k] = i2f(mts == NEG_SENT ? NUL : wsub(max_ts, mts));
        }
        const int mt_max = v(C_max_ts_aid);
        const bool has_mt = mt_max != NEG_SENT;
        o[F_since_session_start_ts_aid] = i2f(has_mt ? wsub(mt_max, min_ts) : NUL);
        const int mto_max = v(C_max_ts_aid_orders);
        o[F_since_session_start_ts_aid_orders] =
            i2f(mto_max != NEG_SENT ? wsub(mto_max, min_ts) : NUL);
        o[F_rel_pos_max_ts_aid_in_session] = i2f(
            has_mt ? f2i(__fmul_rn(__fdiv_rn(i2f(wsub(mt_max, min_ts)), span1), 100.0f)) : NUL);
        const float rel_mt = __fdiv_rn(i2f(v(C_sum_rel_max_ts_aid)), __fmul_rn(n_uniq_f, span1));
        o[F_rel_pos_mean_max_ts_aid_in_session] =
            i2f(has_mt ? f2i(__fmul_rn(rel_mt, 100.0f)) : NUL);
        const int cnt_o = v(C_cnt_max_ts_aid_orders);
        const float rel_mto = __fdiv_rn(i2f(v(C_sum_rel_max_ts_aid_orders)),
                                        __fmul_rn(i2f(max(cnt_o, 1)), span1));
        o[F_rel_pos_mean_max_ts_aid_orders_in_session] =
            i2f(cnt_o > 0 ? f2i(__fmul_rn(rel_mto, 100.0f)) : NUL);
        o[F_ts_order_aid] = i2f(min(max(ts_c, 0), 999));
        for (int k = 0; k < 4; ++k) {
          o[F_ts_order_aid_rel + k] = nul_to(v(C_ts_order_aid_rel + k), SENT);
        }
        o[F_ts_aid_rel_pos_in_session] =
            i2f(n_uniq > 0 ? f2i(__fdiv_rn(i2f(v(C_sum_rel_pos)), n_uniq_f)) : NUL);
        o[F_rank_by_n_aid] = nul_to(v(C_rank_by_n_aid), SENT);

        // co-visitation: count-weighted means, absent -> -1
        for (int t = 0; t < 5; ++t) {
          const int cnt = v(C_cov0_count + CO * t);
          const bool has = cnt > 0;
          const float cnt_f = i2f(max(cnt, 1));
          auto mean = [&](int k) {
            return i2f(has ? f2i(__fdiv_rn(i2f(v(C_cov0_count + CO * t + k)), cnt_f)) : NUL);
          };
          float* f = o + F_click_to_click_count + FO * t;
          f[0] = i2f(has ? cnt : NUL);
          f[1] = mean(C_cov0_num_count_pop - C_cov0_count);
          f[2] = mean(C_cov0_num_perc_pop - C_cov0_count);
          f[3] = mean(C_cov0_num_rank - C_cov0_count);
          f[4] = mean(C_cov0_num_count_rel - C_cov0_count);
        }

        // w2vec aggregates, absent -> -1
        for (int m = 0; m < 2; ++m) {
          const int n = v(C_w2v_all_n + WC * m);
          const bool has = n > 0;
          const float n_f = i2f(max(n, 1));
          float* f = o + F_n_w2vec_all + WF * m;
          f[0] = i2f(n);
          f[1] = has ? __fdiv_rn(__int_as_float(v(C_w2v_all_sum_dist + WC * m)), n_f) : -1.0f;
          f[2] = i2f(has ? f2i(__fdiv_rn(i2f(v(C_w2v_all_sum_rank + WC * m)), n_f)) : NUL);
          f[3] = i2f(has ? v(C_w2v_all_best_rank + WC * m) : NUL);
        }

        // source flags
        o[F_src_any] = 1.0f;
        o[F_src_self] = v(C_slf_present) > 0 ? 1.0f : 0.0f;
        for (int t = 0; t < 5; ++t) {
          const int n_t = v(t < 2 ? C_n_aid_clicks : (t < 4 ? C_n_aid_carts : C_n_aid_orders));
          o[F_src_click_to_click + t] = n_t > 0 && v(C_cov0_count + CO * t) > 0 ? 1.0f : 0.0f;
        }
        o[F_src_w2vec_all] = v(C_w2v_all_n) > 0 ? 1.0f : 0.0f;
        o[F_src_w2vec_1_2] = v(C_w2v_12_n) > 0 ? 1.0f : 0.0f;
        o[F_src_pop_cl50] = v(C_pop_present) > 0 ? 1.0f : 0.0f;

        // popularity ranks; a candidate beyond the tables reads their last
        // row (PyTorch's indexing would raise)
        for (int k = 0; k < 6; ++k) o[F_rank_clicks_cl50 + k] = nul_to(v(C_pop_0 + k), SENT);
        const int64_t prow = min(cand, a_pop - 1);
        for (int k = 0; k < 3; ++k) o[F_rank_clicks_cl1 + k] = i2f(__ldg(pop_cl1 + prow * k_pop + k));

        // embedding similarity: dot product and both norms in four strands
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float cq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float sq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const float* row = aid_emb + static_cast<int64_t>(min(cand, a_emb - 1)) * D;
        if (VEC) {
          const float4* r4 = reinterpret_cast<const float4*>(row);
          const float4* e4 = reinterpret_cast<const float4*>(ses);
#pragma unroll 5
          for (int j = 0; j < D / 4; ++j) {
            const float4 x = __ldg(r4 + j);
            const float4 e = e4[j];
            dp[0] = fmaf(e.x, x.x, dp[0]); cq[0] = fmaf(x.x, x.x, cq[0]); sq[0] = fmaf(e.x, e.x, sq[0]);
            dp[1] = fmaf(e.y, x.y, dp[1]); cq[1] = fmaf(x.y, x.y, cq[1]); sq[1] = fmaf(e.y, e.y, sq[1]);
            dp[2] = fmaf(e.z, x.z, dp[2]); cq[2] = fmaf(x.z, x.z, cq[2]); sq[2] = fmaf(e.z, e.z, sq[2]);
            dp[3] = fmaf(e.w, x.w, dp[3]); cq[3] = fmaf(x.w, x.w, cq[3]); sq[3] = fmaf(e.w, e.w, sq[3]);
          }
        } else {   // the same strands from 4-byte loads
          int d = 0;
          for (; d + 4 <= D; d += 4) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float x = __ldg(row + d + k), e = ses[d + k];
              dp[k] = fmaf(e, x, dp[k]); cq[k] = fmaf(x, x, cq[k]); sq[k] = fmaf(e, e, sq[k]);
            }
          }
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (d + k < D) {
              const float x = __ldg(row + d + k), e = ses[d + k];
              dp[k] = fmaf(e, x, dp[k]); cq[k] = fmaf(x, x, cq[k]); sq[k] = fmaf(e, e, sq[k]);
            }
          }
        }
        const float dot = __fadd_rn(__fadd_rn(dp[0], dp[1]), __fadd_rn(dp[2], dp[3]));
        const float n_c = __fsqrt_rn(__fadd_rn(__fadd_rn(cq[0], cq[1]), __fadd_rn(cq[2], cq[3])));
        const float n_s = __fsqrt_rn(__fadd_rn(__fadd_rn(sq[0], sq[1]), __fadd_rn(sq[2], sq[3])));
        const bool has_emb = n_c > 1e-9f;
        const float cosv = __fdiv_rn(dot, clamp_min(__fmul_rn(n_s, n_c), 1e-9f));
        const float e2 = __fsub_rn(__fadd_rn(__fmul_rn(n_s, n_s), __fmul_rn(n_c, n_c)),
                                   __fmul_rn(2.0f, dot));
        o[F_cos_sim_ses_aid] = has_emb ? cosv : 0.0f;
        o[F_eucl_dist_ses_aid] = has_emb ? __fsqrt_rn(clamp_min(e2, 0.0f)) : -1.0f;

        // heuristic prior: 10 / max(slf_ts_order, 1) for a self candidate,
        // then each table's count_rel / 100 where positive, in table order
        float heur = v(C_slf_present) > 0
            ? __fmul_rn(__frcp_rn(clamp_min(o[F_slf_ts_order], 1.0f)), 10.0f) : 0.0f;
        for (int t = 0; t < 5; ++t) {
          const float crel = o[F_click_to_click_count_rel + FO * t];
          heur = __fadd_rn(heur, crel > 0.0f ? __fmul_rn(crel, 1.0f / 100.0f) : 0.0f);
        }
        o[F_heur_score] = heur;
      }
    }
  }
  __syncthreads();

  // the tile's slots are contiguous in feats: coalesced stores
  const int n = min(TILE, Cmax - c0);
  float* dst = feats + (static_cast<int64_t>(s) * Cmax + c0) * NFEAT;
  for (int i = threadIdx.x; i < n * NFEAT; i += TILE) {
    const int r = i / NFEAT;
    dst[i] = tile[r * ROW + (i - r * NFEAT)];
  }
}

}  // namespace

// cols: NCOLS pointers to [S, C] contiguous 32-bit columns (COLUMNS order);
// stats: NSTATS pointers to [S] int32; pk [S, C] int32 at row stride ld_pk;
// pop_cl1 [a_pop, k_pop] int32 (k_pop >= 3); aid_emb [a_emb, D] and ses_emb
// [S, D] float32, contiguous -> cand, ts_order [S, Cmax] int32 and feats
// [S, Cmax, NFEAT] float32. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int otto_retrieval_features(const void* const* cols, int n_cols,
                                       const void* const* stats, int n_stats, const void* pk,
                                       long long ld_pk, const void* pop_cl1, int a_pop,
                                       int k_pop, const void* aid_emb, int a_emb,
                                       const void* ses_emb, int D, void* cand, void* ts_order,
                                       void* feats, int S, int C, int Cmax, void* stream) {
  if (n_cols != NCOLS || n_stats != NSTATS || S < 0 || C < 0 || Cmax < C || ld_pk < C ||
      a_pop < 1 || k_pop < 3 || a_emb < 1 || D < 1 || D > MAX_D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (Cmax + TILE - 1) / TILE;
  if (S == 0 || tiles == 0) return static_cast<int>(cudaGetLastError());
  if (static_cast<long long>(S) * tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in;
  for (int k = 0; k < NCOLS; ++k) in.col[k] = static_cast<const int32_t*>(cols[k]);
  for (int k = 0; k < NSTATS; ++k) in.stat[k] = static_cast<const int32_t*>(stats[k]);
  const int smem = 4 * (TILE * ROW + ((D + 3) & ~3));
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(aid_emb) % 16 == 0;
  auto kernel = vec ? retrieval_features_kernel<true> : retrieval_features_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<static_cast<unsigned>(S * tiles), TILE, smem, static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(pk), ld_pk, static_cast<const int32_t*>(pop_cl1), a_pop,
      k_pop, static_cast<const float*>(aid_emb), a_emb, static_cast<const float*>(ses_emb), D,
      static_cast<int32_t*>(cand), static_cast<int32_t*>(ts_order), static_cast<float*>(feats),
      C, Cmax);
  return static_cast<int>(cudaGetLastError());
}
