// K8: retrieval's Stage D, the level-2 groupby's columns, in two launches
// around one key sort. The key launch reads the level-1 groupby's outputs
// (its sorted keys, segment ends and reductions) and writes the level-2
// keys `key2` [S, P1 + T]: every level-1 entry the recency-adaptive trim
// keeps, then the session cluster's valid popularity candidates, SENT
// elsewhere; and one flag byte a level-1 lane (bit 0 kept, bit 1 the
// session's own aid). torch.sort(key2, stable) then gives ks2 and perm. The
// column launch writes, for every lane i of the sorted order, the NCOLS
// columns the scans and Stage E read, each at its place in sort order, in
// one [NCOLS, S, P2] buffer grouped by (dtype, reducer), and the segment
// flags `first` and `is_end` of ks2. K2 scans each group as it lies.
//
// Replaces no Pallas kernel: otto_tpu runs Stage D as XLA ops fused under
// jit. The port built the columns with ~365 eager PyTorch launches a batch
// (wheres, products, the popularity lanes' padding), stacked them and moved
// them through the sort with K1, and the launches' host time set pass B's
// pace. Its plain twin is `engine/retrieval.py::_columns_program`, which a
// CPU batch runs.
//
// Every word written is the twin's word moved to its sorted lane: int32
// arithmetic wraps as PyTorch's does (the co-visitation count products),
// and the trim's three float32 operations round once each (__fsub_rn,
// __fmul_rn: nvcc would otherwise contract them into an FMA), as PyTorch's
// separate elementwise launches do. A lane whose sorted key is SENT holds
// the reducers' identities: every lane the twin does not keep does, and a
// kept lane never carries SENT.
//
// What bounds it on the card: bytes. A sorted lane writes NCOLS words and
// its two flags and reads its key and its int64 source index; a kept lane
// reads ~47 level-1 words of its source lane (each level-1 row is read by
// the lanes of one session, so it is reused in L2), a popularity lane six
// ranks. At 2,048 sessions x 4,000 lanes (the 32 and longer buckets) that is
// ~2.9 GB, ~0.9 ms at 3.35 TB/s. The design: one thread a sorted lane, a
// block TILE consecutive lanes of one session (blocks of a session
// adjacent, so its level-1 rows stay in L2); every column's store is
// coalesced across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;                // lanes a block, one thread each
constexpr int SENT = 2147483647;         // an empty key, the int32 min identity
constexpr int NEG_SENT = -2147483647;    // the int32 max identity
constexpr int NUL = -1;                  // a stat's null
constexpr int AID_MASK = (1 << 21) - 1;  // a level-1 key's candidate bits
constexpr int POP_TOP = 20;              // a popularity candidate is kept within this rank
constexpr int N_POP = 6;                 // the popularity ranks carried

// The level-1 columns a launch reads, in ops/kernels/retrieval_columns.py
// INPUTS order (tests/test_torch_retrieval_columns.py holds the two
// equal): the co-visitation and w2vec reductions, then the carried
// per-source-aid stats. The two w2vec distances are float32, read as words.
enum Input : int {
  I_cov0_count, I_cov0_count_pop, I_cov0_perc_pop, I_cov0_count_rel, I_cov0_rank,
  I_cov1_count, I_cov1_count_pop, I_cov1_perc_pop, I_cov1_count_rel, I_cov1_rank,
  I_cov2_count, I_cov2_count_pop, I_cov2_perc_pop, I_cov2_count_rel, I_cov2_rank,
  I_cov3_count, I_cov3_count_pop, I_cov3_perc_pop, I_cov3_count_rel, I_cov3_rank,
  I_cov4_count, I_cov4_count_pop, I_cov4_perc_pop, I_cov4_count_rel, I_cov4_rank,
  I_w2v_all_rank, I_w2v_all_dist, I_w2v_12_rank, I_w2v_12_dist,
  I_sa_src, I_sa_n_aid, I_sa_n_aid_clicks, I_sa_n_aid_carts, I_sa_n_aid_orders,
  I_sa_rank_by_n_aid, I_sa_rank_by_n_aid_carts, I_sa_rank_by_n_aid_orders,
  I_sa_max_ts_aid, I_sa_max_ts_aid_clicks, I_sa_max_ts_aid_carts, I_sa_max_ts_aid_orders,
  I_sa_ts_order_aid, I_sa_ts_order_aid_rel, I_sa_ts_order_aid_clicks,
  I_sa_ts_order_aid_carts, I_sa_ts_order_aid_orders, I_sa_ts_aid_rel_pos_in_session,
  I_sa_left_in_cart,
  NINPUTS
};

// The columns written, in retrieval_columns.py COLUMNS order: the int32
// sums, the int32 maxima, the int32 minima, the float32 sums (GROUP_FIRST
// marks each group's first). A run of columns named alike is indexed from
// its first.
enum Column : int {
  C_n_uniq_aid, C_n_uniq_aid_clicks, C_n_uniq_aid_carts, C_n_uniq_aid_orders,
  C_n_aid, C_n_aid_clicks, C_n_aid_carts, C_n_aid_orders,
  C_sum_rel_max_ts_aid, C_sum_rel_max_ts_aid_orders, C_cnt_max_ts_aid_orders, C_sum_rel_pos,
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
  C_w2v_all_n, C_w2v_all_sum_rank, C_w2v_12_n, C_w2v_12_sum_rank,
  C_slf_present, C_slf_n, C_slf_n_clicks, C_slf_n_carts, C_slf_n_orders, C_slf_left_in_cart,
  C_pop_present,
  C_max_ts_aid, C_max_ts_aid_clicks, C_max_ts_aid_carts, C_max_ts_aid_orders,
  C_slf_max_ts, C_slf_max_ts_clicks, C_slf_max_ts_carts, C_slf_max_ts_orders,
  C_ts_order_aid, C_ts_order_aid_rel, C_ts_order_aid_clicks, C_ts_order_aid_carts,
  C_ts_order_aid_orders, C_rank_by_n_aid, C_w2v_all_best_rank, C_w2v_12_best_rank,
  C_slf_rank_by_n, C_slf_rank_by_n_carts, C_slf_rank_by_n_orders, C_slf_ts_rel_pos,
  C_slf_ts_order, C_slf_ts_order_rel, C_slf_ts_order_clicks, C_slf_ts_order_carts,
  C_slf_ts_order_orders,
  C_pop_0, C_pop_1, C_pop_2, C_pop_3, C_pop_4, C_pop_5,
  C_w2v_all_sum_dist, C_w2v_12_sum_dist,
  NCOLS
};

// The (dtype, reducer) groups, in retrieval_columns.py GROUPS order; K2
// scans each as one [G, S, P2] tensor.
enum Group : int { G_int32_sum, G_int32_max, G_int32_min, G_float32_sum, NGROUPS };
constexpr int GROUP_FIRST[NGROUPS + 1] = {C_n_uniq_aid, C_max_ts_aid, C_ts_order_aid, C_w2v_all_sum_dist, NCOLS};

constexpr int CI = I_cov1_count - I_cov0_count;            // inputs a co-visitation table
constexpr int CC = C_cov1_count - C_cov0_count;            // columns a co-visitation table
static_assert(CI == 5 && CC == 5 && NINPUTS == 48 && NCOLS == 81, "inputs and columns");
static_assert(C_pop_5 - C_pop_0 == N_POP - 1, "six popularity ranks");

static_assert(GROUP_FIRST[G_int32_max] == C_max_ts_aid && GROUP_FIRST[G_int32_min] == C_ts_order_aid
              && GROUP_FIRST[G_float32_sum] == C_w2v_all_sum_dist, "group bounds");

// the reducer's identity of column c (float32 0 is the word 0)
__device__ __forceinline__ constexpr int identity(int c) {
  return c >= C_ts_order_aid && c < C_w2v_all_sum_dist ? SENT
       : c >= C_max_ts_aid && c < C_ts_order_aid ? NEG_SENT : 0;
}

// the level-1 column pointers, by value
struct Inputs {
  const int32_t* in[NINPUTS];
};

__device__ __forceinline__ int wsub(int a, int b) {   // int32 a - b, wrapping
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {   // int32 a * b, wrapping
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int nul_to(int x, int repl) { return x == NUL ? repl : x; }
// torch.maximum on float32: NaN if either is
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// One thread a level-1 lane j < P1 (the trim) or popularity slot j - P1.
__global__ void __launch_bounds__(TILE)
retrieval_keys_kernel(const __grid_constant__ Inputs in, const int32_t* __restrict__ ks1,
                      const uint8_t* __restrict__ end1, const float* __restrict__ trim,
                      const int32_t* __restrict__ cluster, const int32_t* __restrict__ pop_cand,
                      const int32_t* __restrict__ pop_ranks, int n_cl, int T, int K,
                      int32_t* __restrict__ key2, uint8_t* __restrict__ flags, int P1) {
  const int W = P1 + T;
  const int tiles = (W + TILE - 1) / TILE;
  const int s = blockIdx.x / tiles;
  const int j = (blockIdx.x - s * tiles) * TILE + threadIdx.x;
  if (j >= W) return;
  const int64_t out_at = static_cast<int64_t>(s) * W + j;
  if (j >= P1) {   // popularity slot: its candidate if one of its ranks is within POP_TOP
    const int g = min(max(__ldg(cluster + s), 0), n_cl - 1);
    const int64_t e = static_cast<int64_t>(g) * T + (j - P1);
    const int cand = __ldg(pop_cand + e);
    int best = SENT;
    for (int k = 0; k < K; ++k) best = min(best, __ldg(pop_ranks + e * K + k));
    key2[out_at] = cand >= 0 && best <= POP_TOP ? cand : SENT;
    return;
  }
  const int64_t at = static_cast<int64_t>(s) * P1 + j;
  const int ks = __ldg(ks1 + at);
  const bool e_valid = __ldg(end1 + at) != 0;
  const int e_cand = ks != SENT ? (ks & AID_MASK) : -1;
  bool is_self = false, keep = false;
  if (e_valid) {
    auto v = [&](int k) { return __ldg(in.in[k] + at); };
    is_self = e_cand == v(I_sa_src);
    // the recency-adaptive trim: the source aid's best order sets how deep
    // a source's ranks are kept, max(max_at_1 - delta (order - 1), min_n)
    const int order = min(
        min(min(nul_to(v(I_sa_rank_by_n_aid), SENT), nul_to(v(I_sa_ts_order_aid), SENT)),
            nul_to(v(I_sa_ts_order_aid_clicks), SENT)),
        min(nul_to(v(I_sa_ts_order_aid_carts), SENT), nul_to(v(I_sa_ts_order_aid_orders), SENT)));
    const float th = fmax_nan(
        __fsub_rn(__ldg(trim + 0),
                  __fmul_rn(__ldg(trim + 2), __fsub_rn(__int2float_rn(order), 1.0f))),
        __ldg(trim + 1));
    int best_co = v(I_cov0_rank);
    for (int t = 1; t < 5; ++t) best_co = min(best_co, v(I_cov0_rank + CI * t));
    const int best_w2v = min(v(I_w2v_all_rank), v(I_w2v_12_rank));
    keep = is_self || __int2float_rn(best_co) <= th || __int2float_rn(best_w2v) <= th;
  }
  key2[out_at] = keep ? e_cand : SENT;
  flags[at] = static_cast<uint8_t>((keep ? 1 : 0) | (is_self ? 2 : 0));
}

// One thread a lane i of the sorted order: its segment flags, then its
// NCOLS words, from the level-1 lane or popularity slot perm[i] names.
__global__ void __launch_bounds__(TILE)
retrieval_columns_kernel(const __grid_constant__ Inputs in, const int32_t* __restrict__ ks2,
                         const int64_t* __restrict__ perm, const uint8_t* __restrict__ flags,
                         const int32_t* __restrict__ min_ts, const int32_t* __restrict__ cluster,
                         const int32_t* __restrict__ pop_ranks, int n_cl, int T, int K,
                         int32_t* __restrict__ out, uint8_t* __restrict__ first_out,
                         uint8_t* __restrict__ end_out, int S, int P1, int P2) {
  const int tiles = (P2 + TILE - 1) / TILE;
  const int s = blockIdx.x / tiles;
  const int i = (blockIdx.x - s * tiles) * TILE + threadIdx.x;
  if (i >= P2) return;
  const int64_t row = static_cast<int64_t>(s) * P2;
  const int key = __ldg(ks2 + row + i);
  // first: the key differs from the lane before (NEG_SENT before lane 0);
  // is_end: the next lane starts a segment (or there is none), key not SENT
  const int prev = i == 0 ? NEG_SENT : __ldg(ks2 + row + i - 1);
  const bool last = i == P2 - 1 || __ldg(ks2 + row + i + 1) != key;
  first_out[row + i] = key != prev;
  end_out[row + i] = last && key != SENT;

  const int64_t plane = static_cast<int64_t>(S) * P2;
  int32_t* o = out + row + i;
  auto put = [&](int c, int x) { o[c * plane] = x; };
  if (key == SENT) {
#pragma unroll
    for (int c = 0; c < NCOLS; ++c) put(c, identity(c));
    return;
  }
  const int64_t p = __ldg(perm + row + i);
  if (p >= P1) {   // a kept popularity candidate: its six ranks, identities elsewhere
    const int g = min(max(__ldg(cluster + s), 0), n_cl - 1);
    const int32_t* r = pop_ranks + (static_cast<int64_t>(g) * T + (p - P1)) * K;
#pragma unroll
    for (int c = 0; c < NCOLS; ++c) {
      if (c < C_pop_0 || c > C_pop_5) put(c, c == C_pop_present ? 1 : identity(c));
    }
    for (int k = 0; k < N_POP; ++k) put(C_pop_0 + k, __ldg(r + k));
    return;
  }

  // a kept level-1 entry
  const int64_t at = static_cast<int64_t>(s) * P1 + p;
  auto v = [&](int k) { return __ldg(in.in[k] + at); };
  const bool self = (__ldg(flags + at) & 2) != 0;
  const int t0 = __ldg(min_ts + s);

  // int32 sums
  put(C_n_uniq_aid, 1);
  for (int k = 0; k < 3; ++k) put(C_n_uniq_aid_clicks + k, v(I_sa_n_aid_clicks + k) > 0);
  for (int k = 0; k < 4; ++k) {
    const int n = v(I_sa_n_aid + k);
    put(C_n_aid + k, n);
    put(C_slf_n + k, self ? n : 0);
  }
  const int mt = v(I_sa_max_ts_aid);
  put(C_sum_rel_max_ts_aid, mt == NUL ? 0 : wsub(mt, t0));
  const int mto = v(I_sa_max_ts_aid_orders);
  put(C_sum_rel_max_ts_aid_orders, mto != NUL ? wsub(mto, t0) : 0);
  put(C_cnt_max_ts_aid_orders, mto != NUL);
  const int relp = v(I_sa_ts_aid_rel_pos_in_session);
  put(C_sum_rel_pos, relp == NUL ? 0 : relp);
  for (int t = 0; t < 5; ++t) {
    const int cnt = v(I_cov0_count + CI * t);
    const int rk = v(I_cov0_rank + CI * t);
    int32_t* c0 = o + (C_cov0_count + CC * t) * plane;
    c0[0] = cnt;
    c0[1 * plane] = wmul(v(I_cov0_count_pop + CI * t), cnt);
    c0[2 * plane] = wmul(v(I_cov0_perc_pop + CI * t), cnt);
    c0[3 * plane] = wmul(v(I_cov0_count_rel + CI * t), cnt);
    c0[4 * plane] = wmul(rk == SENT ? 0 : rk, cnt);
  }
  for (int m = 0; m < 2; ++m) {
    const int rk = v(I_w2v_all_rank + 2 * m);
    const bool present = rk != SENT;
    put(C_w2v_all_n + 2 * m, present);
    put(C_w2v_all_sum_rank + 2 * m, present ? rk : 0);
    put(C_w2v_all_best_rank + m, rk);
    put(C_w2v_all_sum_dist + m, present ? v(I_w2v_all_dist + 2 * m) : 0);
  }
  put(C_slf_present, self);
  put(C_slf_left_in_cart, self ? v(I_sa_left_in_cart) : 0);
  put(C_pop_present, 0);

  // int32 maxima: a null time is NEG_SENT
  for (int k = 0; k < 4; ++k) {
    const int x = nul_to(v(I_sa_max_ts_aid + k), NEG_SENT);
    put(C_max_ts_aid + k, x);
    put(C_slf_max_ts + k, self ? x : NEG_SENT);
  }

  // int32 minima: a null order or rank is SENT
  for (int k = 0; k < 5; ++k) {
    const int x = nul_to(v(I_sa_ts_order_aid + k), SENT);
    put(C_ts_order_aid + k, x);
    put(C_slf_ts_order + k, self ? x : SENT);
  }
  put(C_rank_by_n_aid, nul_to(v(I_sa_rank_by_n_aid), SENT));
  for (int k = 0; k < 3; ++k) {
    put(C_slf_rank_by_n + k, self ? nul_to(v(I_sa_rank_by_n_aid + k), SENT) : SENT);
  }
  put(C_slf_ts_rel_pos, self ? nul_to(relp, SENT) : SENT);
  for (int k = 0; k < N_POP; ++k) put(C_pop_0 + k, SENT);
}

}  // namespace

// inputs: NINPUTS pointers to [S, P1] contiguous 32-bit level-1 columns
// (INPUTS order); ks1 [S, P1] int32, end1 [S, P1] bool; trim [3] float32
// (max_at_1, min_n, delta); cluster [S] int32; pop_cand [n_cl, T] and
// pop_ranks [n_cl, T, K] int32 (K >= 6), contiguous -> key2 [S, P1 + T]
// int32 and flags [S, P1] uint8. Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int otto_retrieval_keys(const void* const* inputs, int n_inputs, const void* ks1,
                                   const void* end1, const void* trim, const void* cluster,
                                   const void* pop_cand, const void* pop_ranks, int n_cl, int T,
                                   int K, void* key2, void* flags, int S, int P1, void* stream) {
  if (n_inputs != NINPUTS || S < 0 || P1 < 0 || T < 0 || n_cl < 1 || K < N_POP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(P1) + T + TILE - 1) / TILE;
  if (S == 0 || tiles == 0) return static_cast<int>(cudaGetLastError());
  if (S * tiles > 0x7fffffffLL || P1 + static_cast<long long>(T) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Inputs in;
  for (int k = 0; k < NINPUTS; ++k) in.in[k] = static_cast<const int32_t*>(inputs[k]);
  retrieval_keys_kernel<<<static_cast<unsigned>(S * tiles), TILE, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(ks1), static_cast<const uint8_t*>(end1),
      static_cast<const float*>(trim), static_cast<const int32_t*>(cluster),
      static_cast<const int32_t*>(pop_cand), static_cast<const int32_t*>(pop_ranks), n_cl, T, K,
      static_cast<int32_t*>(key2), static_cast<uint8_t*>(flags), P1);
  return static_cast<int>(cudaGetLastError());
}

// inputs as above; ks2 [S, P2] int32 and perm [S, P2] int64 (the stable
// sort of key2, P2 = P1 + T); flags [S, P1] uint8 from otto_retrieval_keys;
// min_ts, cluster [S] int32; pop_ranks [n_cl, T, K] int32, contiguous ->
// out [NCOLS, S, P2] 32-bit words (COLUMNS order), first and is_end [S, P2]
// bool. Returns as otto_retrieval_keys does.
extern "C" int otto_retrieval_columns(const void* const* inputs, int n_inputs, const void* ks2,
                                      const void* perm, const void* flags, const void* min_ts,
                                      const void* cluster, const void* pop_ranks, int n_cl, int T,
                                      int K, void* out, void* first, void* is_end, int S, int P1,
                                      int P2, void* stream) {
  if (n_inputs != NINPUTS || S < 0 || P1 < 0 || T < 0 || P2 != P1 + T || n_cl < 1 ||
      K < N_POP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(P2) + TILE - 1) / TILE;
  if (S == 0 || tiles == 0) return static_cast<int>(cudaGetLastError());
  if (S * tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Inputs in;
  for (int k = 0; k < NINPUTS; ++k) in.in[k] = static_cast<const int32_t*>(inputs[k]);
  retrieval_columns_kernel<<<static_cast<unsigned>(S * tiles), TILE, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int32_t*>(ks2), static_cast<const int64_t*>(perm),
      static_cast<const uint8_t*>(flags), static_cast<const int32_t*>(min_ts),
      static_cast<const int32_t*>(cluster), static_cast<const int32_t*>(pop_ranks), n_cl, T, K,
      static_cast<int32_t*>(out), static_cast<uint8_t*>(first), static_cast<uint8_t*>(is_end), S,
      P1, P2);
  return static_cast<int>(cudaGetLastError());
}
