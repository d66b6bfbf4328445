// Fused interaction span of the batched step for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces metta_tpu/ops/sim_fused.py:150, the inner `kernel` of
// build_fused_kernel (the Pallas TPU kernel behind call_fused and
// fused_step_full). Same function: decode, change_vibe, vibe-triggered attack
// and transfer, swaps with frozen agents, the four rank-arbitrated move
// rounds, the assembler phase and action consumption, byte-identical to the
// plain torch version metta_tpu_torch/engine/step_batched.py:interaction_span.
// The chest phase is not here: no ported config has chests, and the wrapper
// refuses them.
//
// Design: one warp per env, lane = agent (A <= 32; lanes >= A hold no agent
// and only take part in the warp's shuffles and barriers), ENVS_PER_BLOCK
// envs per block. What the TPU kernel spells as [A, A*EL] pair-mats becomes a
// loop over the env's A agents with __shfl_sync (the target's frozen count,
// vibe and position; the lowest rank per target, cell or station). Sums into
// targets are atomicAdd on ints in shared memory: an integer sum is the same
// in any order, so results stay byte-exact. The env's inventory rows [A][R],
// a delta buffer [A][R] and the gained/lost accumulators live in shared
// memory; every phase adds its deltas to the buffer and then each lane clamps
// its own row once, as the plain version's one clamp per phase does. The
// assembler phase runs on the winner lane of each claimed station: its 8
// neighbours (from the agents' final positions), the sorted vibe key,
// protocol pick, the rotated neighbour order, the occurrence-index output
// selection and the two shared-consume passes over 8 slots x the protocol
// resources, in registers. Tables are read from device memory (one int32
// pack, offsets in the kernel's Static argument); the TPU kernel baked them
// into its code. The kernel reads the target cells' static_kind, static_idx
// and agent_grid itself (the TPU wrapper packed them in a pass before it),
// and takes any E (no 128-env blocks).
//
// What bounds it: bytes. Per env it reads the agents' fields and inventories,
// the cells its movers target and the station fields, and writes the same
// back; at E=4096 on the combat map that is about 3 KB in and 3 KB out an
// env, 25 MB in all, 7.4 us at 3.35 TB/s (chip_smoke.py:k2_work counts it
// from a run's inputs). The work per env is small and serial (a warp walks A agents per
// pair term), so the design keeps every intermediate on chip: inputs are read
// once (inventories with the env's lanes reading consecutive words), phases
// talk through shared memory, and outputs are written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ENVS_PER_BLOCK = 4;

// Order of the tables in the int32 pack; ops/sim_fused.py:TABLES lists the
// same names in the same order.
enum Tab {
  T_ACTION_KIND, T_ACTION_ARG, T_ACTION_REQUIRED, T_ACTION_CONSUMED, T_MOVE_DELTAS,
  T_ATTACK_VIBE_MASK, T_ATTACK_CONSUMED, T_ATTACK_DEFENSE, T_ATTACK_DEFENSE_MASK,
  T_ATTACK_ARMOR_W, T_ATTACK_WEAPON_W, T_ATTACK_VIBE_BONUS, T_VIBE_MATCHES_RESOURCE,
  T_ATTACK_ACTOR_DELTA, T_ATTACK_TARGET_DELTA,
  T_TRANSFER_VIBE_MASK, T_TRANSFER_REQUIRED, T_TRANSFER_ACTOR_DELTA, T_TRANSFER_TARGET_DELTA,
  T_TYPE_MAX_USES,
  T_PROTO_TYPE, T_PROTO_KEY, T_PROTO_MIN_AGENTS, T_PROTO_IN, T_PROTO_OUT, T_PROTO_COOLDOWN,
  T_PROTO_NVIBES, T_PROTO_VIBE_COUNTS, T_PROTO_RANK, T_PROTO_VALID,
  T_UPROTO_KEY, T_UPROTO_MIN_AGENTS, T_UPROTO_IN, T_UPROTO_OUT, T_UPROTO_COOLDOWN,
  T_UPROTO_NVIBES, T_UPROTO_VIBE_COUNTS,
  T_LIMS, T_LOOT, T_PROTO_RES,
  N_TAB
};

// Sizes and statics of one config; ops/sim_fused.py:_Static mirrors it.
struct Static {
  int A, R, V, H, W, NACT, NA, NP, NUP, n_loot, n_pres;
  int has_attack, has_transfer, has_swap, has_asm, track_gained, any_consumed;
  int defense_any, attack_freeze;
  int act_noop, act_move, act_change_vibe, kind_asm;
  int off[N_TAB];
};

// Inputs, in the order of ops/sim_fused.py:_IN.
struct In {
  const int32_t *actions, *rank, *r, *c, *vibe, *frozen, *inv, *gained, *lost, *step;
  const int32_t *agent_grid, *static_kind, *static_idx;
  const int32_t *asm_r, *asm_c, *asm_type, *asm_uses, *asm_cd_end, *asm_cd_dur;
  const uint8_t* asm_clipped;
  const int32_t* asm_uproto;
  const uint8_t* asm_valid;
};

// Outputs, in the order of ops/sim_fused.py:_OUT.
struct Out {
  int32_t *r, *c, *vibe, *frozen, *inv, *gained, *lost;
  int32_t *asm_cd_dur, *asm_cd_end, *asm_uses;
  uint8_t* asm_clipped;
  int32_t* asm_uproto;
  uint8_t* success;
  int32_t* executed;
};

constexpr int N_IN = 22;
constexpr int N_OUT = 14;

__constant__ int NEIGHBOR_OFFS[8][2] = {
    {-1, -1}, {-1, 0}, {-1, 1}, {0, -1}, {0, 1}, {1, -1}, {1, 0}, {1, 1}};

// Shared ints per env: inventory, delta buffer, gained, lost ([A][R] each),
// then 32-entry arrays: scalar sums, final rows, final cols, vibes, claimed
// station, its cooldown.
__host__ __device__ inline int warp_ints(int A, int R) { return 4 * A * R + 6 * 32; }

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(32 * ENVS_PER_BLOCK)
sim_fused_kernel(In in, Out out, Static s, const int32_t* __restrict__ tab, int E) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * ENVS_PER_BLOCK + warp;
  if (e >= E) return;  // the whole warp leaves; the kernel has no block barrier

  const int A = s.A, R = s.R, V = s.V, H = s.H, W = s.W, NA = s.NA;
  const int AR = A * R;
  int* s_inv = smem + warp * warp_ints(A, R);
  int* s_acc = s_inv + AR;
  int* s_gain = s_acc + AR;
  int* s_lost = s_gain + AR;
  int* s_sum = s_lost + AR;
  int* s_r = s_sum + 32;
  int* s_c = s_r + 32;
  int* s_vibe = s_c + 32;
  int* s_st = s_vibe + 32;
  int* s_cd = s_st + 32;
#define T(name) (tab + s.off[name])
  const int* LIM = T(T_LIMS);

  const bool live = lane < A;
  const int a = live ? lane : 0;
  const int arow = a * R;
  const size_t ea = (size_t)e * A + a;
  const size_t eAR = (size_t)e * AR;
  const int step = in.step[e];

  for (int i = lane; i < AR; i += 32) {
    s_inv[i] = in.inv[eAR + i];
    s_gain[i] = 0;
    s_lost[i] = 0;
  }
  const int act_in = live ? in.actions[ea] : -1;
  const int rank = live ? in.rank[ea] : A + 1 + lane;
  const int r0 = live ? in.r[ea] : 0;
  const int c0 = live ? in.c[ea] : 0;
  const int frozen0 = live ? in.frozen[ea] : 0;
  int vibe = live ? in.vibe[ea] : 0;
  __syncwarp();

  // clamp own row of inv + acc into [0, lim], gained/lost from the net change
  auto apply_acc = [&](bool track_net) {
    if (live) {
      for (int r = 0; r < R; ++r) {
        const int old = s_inv[arow + r];
        const int nw = clampi(old + s_acc[arow + r], 0, LIM[arow + r]);
        s_inv[arow + r] = nw;
        if (s.track_gained) {
          if (track_net) s_gain[arow + r] += max(nw - old, 0);
          s_lost[arow + r] += max(old - nw, 0);
        }
      }
    }
    __syncwarp();
  };
  auto zero_acc = [&]() {
    if (live)
      for (int r = 0; r < R; ++r) s_acc[arow + r] = 0;
    __syncwarp();
  };

  // ---------- decode ----------
  const int NACT = s.NACT;
  const bool act_ok = live && act_in >= 0 && act_in < NACT;
  const int act = clampi(act_in, 0, NACT - 1);
  const int kind = T(T_ACTION_KIND)[act];
  const int arg = T(T_ACTION_ARG)[act];
  const bool is_frozen = frozen0 != 0;
  int frozen = (act_ok && is_frozen && frozen0 > 0) ? frozen0 - 1 : frozen0;
  bool has_req = true;
  for (int r = 0; r < R; ++r)
    has_req = has_req && s_inv[arow + r] >= T(T_ACTION_REQUIRED)[act * R + r];
  const bool attempt = act_ok && !is_frozen && has_req;
  bool success = attempt && kind == s.act_noop;

  // ---------- change_vibe ----------
  const bool cv = attempt && kind == s.act_change_vibe;
  if (cv) vibe = arg;
  success = success || cv;

  // ---------- movement proposals ----------
  bool movers = attempt && kind == s.act_move;
  const int a8 = clampi(arg, 0, 7);
  const int r1 = r0 + T(T_MOVE_DELTAS)[2 * a8];
  const int c1 = c0 + T(T_MOVE_DELTAS)[2 * a8 + 1];
  movers = movers && r1 >= 0 && r1 < H && c1 >= 0 && c1 < W;
  const int flat = clampi(r1, 0, H - 1) * W + clampi(c1, 0, W - 1);
  int skind = 0, sidx = 0, occ0 = 0;
  if (movers) {
    const size_t g = (size_t)e * H * W + flat;
    skind = in.static_kind[g];
    sidx = in.static_idx[g];
    occ0 = in.agent_grid[g];
  }
  const bool has_tgt = movers && occ0 > 0;
  const int tgt = has_tgt ? occ0 - 1 : 0;
  const int vibe_c = clampi(vibe, 0, V - 1);

  auto from_t = [&](int x) {
    const int v = __shfl_sync(FULL, x, tgt);
    return has_tgt ? v : 0;
  };
  auto lowest_rank = [&](bool cand, int key) {
    const int score = cand ? rank : A + 1;
    int best = A + 1;
    for (int t = 0; t < A; ++t) {
      const int kt = __shfl_sync(FULL, key, t);
      const int st = __shfl_sync(FULL, score, t);
      if (kt == key && st < best) best = st;
    }
    return cand && score == best;
  };
  auto sum_to_t = [&](int v, bool m) {
    s_sum[lane] = 0;
    __syncwarp();
    if (m && has_tgt) atomicAdd(&s_sum[tgt], v);
    __syncwarp();
    const int out_v = s_sum[lane];
    __syncwarp();
    return out_v;
  };

  // ---------- vibe-triggered attacks ----------
  bool handled_attack = false;
  if (s.has_attack) {
    const int* AC = T(T_ATTACK_CONSUMED);
    const bool wants = movers && T(T_ATTACK_VIBE_MASK)[vibe_c] && has_tgt;
    bool afford = true;
    for (int r = 0; r < R; ++r) afford = afford && s_inv[arow + r] >= AC[r];
    const bool t_free = from_t(frozen) <= 0;
    const bool valid = lowest_rank(wants && t_free && afford, tgt);

    int weapon = 0;
    for (int r = 0; r < R; ++r) weapon += s_inv[arow + r] * T(T_ATTACK_WEAPON_W)[r];
    const int t_vibe = from_t(vibe_c);
    const int vb = T(T_ATTACK_VIBE_BONUS)[t_vibe];
    const int trow = tgt * R;
    int armor = 0;
    for (int r = 0; r < R; ++r) {
      const int it = has_tgt ? s_inv[trow + r] : 0;
      const int amt = it + (T(T_VIBE_MATCHES_RESOURCE)[t_vibe * R + r] ? vb : 0);
      armor += amt * T(T_ATTACK_ARMOR_W)[r];
    }
    const int bonus = max(weapon - armor, 0);

    bool blocked = false;
    if (s.defense_any) {
      const int* DEF = T(T_ATTACK_DEFENSE);
      const int* DM = T(T_ATTACK_DEFENSE_MASK);
      bool can_defend = true;
      for (int r = 0; r < R; ++r) {
        const int it = has_tgt ? s_inv[trow + r] : 0;
        can_defend = can_defend && (!DM[r] || it >= DEF[r] + bonus);
      }
      blocked = valid && can_defend;
      zero_acc();
      if (blocked && has_tgt)
        for (int r = 0; r < R; ++r)
          if (DM[r]) atomicAdd(&s_acc[trow + r], -(DEF[r] + bonus));
      __syncwarp();
      apply_acc(false);  // the defense clamp tracks only `lost`
    }

    const bool hit = valid && !blocked;
    if (s.attack_freeze > 0) frozen += sum_to_t(s.attack_freeze, hit);
    zero_acc();
    if (live) {
      const int* AAD = T(T_ATTACK_ACTOR_DELTA);
      const int* ATD = T(T_ATTACK_TARGET_DELTA);
      const int* LOOT = T(T_LOOT);
      if (hit)
        for (int r = 0; r < R; ++r) {
          if (AAD[r]) atomicAdd(&s_acc[arow + r], AAD[r]);
          if (has_tgt && ATD[r]) atomicAdd(&s_acc[trow + r], ATD[r]);
        }
      for (int li = 0; li < s.n_loot; ++li) {
        const int rl = LOOT[li];
        const int amount = has_tgt ? s_inv[trow + rl] : 0;
        const int space = max(LIM[arow + rl] - s_inv[arow + rl], 0);
        const int stolen = hit ? min(amount, space) : 0;
        if (stolen) {
          atomicAdd(&s_acc[arow + rl], stolen);
          if (has_tgt) atomicAdd(&s_acc[trow + rl], -stolen);
        }
      }
      if (valid)
        for (int r = 0; r < R; ++r)
          if (AC[r]) atomicAdd(&s_acc[arow + r], -AC[r]);
    }
    __syncwarp();
    apply_acc(true);
    success = success || valid;
    handled_attack = valid;
  }

  // ---------- vibe-triggered transfers ----------
  bool handled_tr = false;
  if (s.has_transfer) {
    const int* TAD = T(T_TRANSFER_ACTOR_DELTA) + vibe_c * R;
    const int* TTD = T(T_TRANSFER_TARGET_DELTA) + vibe_c * R;
    const int* TREQ = T(T_TRANSFER_REQUIRED);
    const bool wants = movers && !handled_attack && T(T_TRANSFER_VIBE_MASK)[vibe_c] && has_tgt;
    bool req_ok = true;
    for (int r = 0; r < R; ++r) req_ok = req_ok && s_inv[arow + r] >= TREQ[r];
    const bool t_free = from_t(frozen) <= 0;
    bool ok = lowest_rank(wants && t_free && req_ok, tgt);
    const int trow = tgt * R;
    for (int r = 0; r < R; ++r) {
      const int da = TAD[r], dt = TTD[r];
      const int inv_a = s_inv[arow + r];
      const int free_a = max(LIM[arow + r] - inv_a, 0);
      const int inv_t = has_tgt ? s_inv[trow + r] : 0;
      const int free_t = has_tgt ? max(LIM[trow + r] - inv_t, 0) : 0;
      ok = ok && (da >= 0 || inv_a >= -da) && (dt >= 0 || inv_t >= -dt) &&
           (da <= 0 || da <= free_a) && (dt <= 0 || dt <= free_t);
    }
    zero_acc();
    if (ok)
      for (int r = 0; r < R; ++r) {
        if (TAD[r]) atomicAdd(&s_acc[arow + r], TAD[r]);
        if (has_tgt && TTD[r]) atomicAdd(&s_acc[trow + r], TTD[r]);
      }
    __syncwarp();
    apply_acc(true);
    success = success || ok;
    handled_tr = ok;
  }

  // ---------- swaps with frozen agents ----------
  bool handled_station = false;
  int cur_r = r0, cur_c = c0;
  if (s.has_swap) {
    const int t_frozen = from_t(frozen);  // every lane shuffles, outside the &&
    const bool wants = movers && !handled_attack && !handled_tr && has_tgt && t_frozen > 0;
    const bool swap_ok = lowest_rank(wants, tgt);
    const bool swapped_in = sum_to_t(1, swap_ok) > 0;
    const int in_r = sum_to_t(r0, swap_ok);
    const int in_c = sum_to_t(c0, swap_ok);
    const int t_r = from_t(r0), t_c = from_t(c0);
    if (swap_ok) { cur_r = t_r; cur_c = t_c; }
    if (swapped_in) { cur_r = in_r; cur_c = in_c; }
    success = success || swap_ok;
    handled_station = wants;
  }
  const bool interacted = handled_attack || handled_tr || handled_station;

  // ---------- plain moves: rank-arbitrated rounds ----------
  bool unresolved = movers && !interacted && skind == 0;
  bool moved = false;
  for (int round = 0; round < 4; ++round) {
    const unsigned un_mask = __ballot_sync(FULL, unresolved);
    const unsigned mv_mask = __ballot_sync(FULL, moved);
    bool occ_any = false, blocker = false;
    for (int t = 0; t < A; ++t) {
      const int rt = __shfl_sync(FULL, cur_r, t);
      const int ct = __shfl_sync(FULL, cur_c, t);
      const int kt = __shfl_sync(FULL, rank, t);
      if (t != lane && r1 == rt && c1 == ct) {
        occ_any = true;
        // blocked by a later-rank agent, or by one that already resolved
        if (kt > rank || !(((un_mask | mv_mask) >> t) & 1u)) blocker = true;
      }
    }
    unresolved = unresolved && !blocker;
    const bool wins = lowest_rank(unresolved, flat) && !occ_any;
    if (wins) { cur_r = r1; cur_c = c1; }
    moved = moved || wins;
    unresolved = unresolved && !wins;
  }
  success = success || moved;

  if (live) {
    s_r[lane] = cur_r;
    s_c[lane] = cur_c;
    s_vibe[lane] = vibe;
  }

  // station fields pass through; claimed stations are overwritten below
  const size_t eNA = (size_t)e * NA;
  for (int i = lane; i < NA; i += 32) {
    out.asm_cd_dur[eNA + i] = in.asm_cd_dur[eNA + i];
    out.asm_cd_end[eNA + i] = in.asm_cd_end[eNA + i];
    out.asm_uses[eNA + i] = in.asm_uses[eNA + i];
    out.asm_clipped[eNA + i] = in.asm_clipped[eNA + i];
    out.asm_uproto[eNA + i] = in.asm_uproto[eNA + i];
  }
  __syncwarp();

  // ---------- assembler phase: the winner lane of each claimed station ----------
  if (s.has_asm) {
    const bool bump = movers && !interacted && skind == s.kind_asm;
    const int st = clampi(sidx, 0, NA - 1);
    const bool is_winner = lowest_rank(bump, st);
    zero_acc();
    bool ok = false;
    int cooldown = 0;
    if (is_winner) {
      const size_t es = eNA + st;
      const int s_type = in.asm_type[es];
      const int uses = in.asm_uses[es];
      const bool clipped = in.asm_clipped[es] != 0;
      const int uproto = in.asm_uproto[es];
      const int sr = in.asm_r[es], sc = in.asm_c[es];
      const int max_uses = T(T_TYPE_MAX_USES)[s_type];
      ok = in.asm_valid[es] != 0 && (max_uses == 0 || uses < max_uses);
      ok = ok && max(in.asm_cd_end[es] - step, 0) == 0;

      // the 8 neighbours of the station, from the agents' final positions
      bool inb[8], isag[8];
      int nidx[8], nvib[8];
      int n_agents = 0;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int rr = sr + NEIGHBOR_OFFS[o][0], cc = sc + NEIGHBOR_OFFS[o][1];
        inb[o] = rr >= 0 && rr < H && cc >= 0 && cc < W;
        isag[o] = false;
        nidx[o] = 0;
        nvib[o] = 0;
        if (inb[o])
          for (int t = 0; t < A; ++t)
            if (s_r[t] == rr && s_c[t] == cc) {
              isag[o] = true;
              nidx[o] = t;
              nvib[o] = s_vibe[t];
            }
        n_agents += isag[o];
      }
      // sorted vibe key by counting: key[j] = #{v in [0, V): cum(v) <= j}
      int key[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) key[j] = 0;
      int cum = 0;
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int o = 0; o < 8; ++o) cum += nvib[o] == v;
#pragma unroll
        for (int j = 0; j < 8; ++j) key[j] += cum <= j;
      }

      // protocol: exact key, else the empty key; highest proto_rank, first wins
      const int* PK = T(T_PROTO_KEY);
      int best_e = -1, idx_e = -1, best_0 = -1, idx_0 = -1;
      for (int p = 0; p < s.NP; ++p) {
        if (!T(T_PROTO_VALID)[p] || T(T_PROTO_TYPE)[p] != s_type ||
            T(T_PROTO_MIN_AGENTS)[p] > n_agents)
          continue;
        bool exact = true, zero = true;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          exact = exact && PK[p * 8 + j] == key[j];
          zero = zero && PK[p * 8 + j] == 0;
        }
        const int sc_p = T(T_PROTO_RANK)[p];
        if (exact && sc_p > best_e) { best_e = sc_p; idx_e = p; }
        if (zero && sc_p > best_0) { best_0 = sc_p; idx_0 = p; }
      }
      const int p_norm = idx_e >= 0 ? idx_e : idx_0;
      int p_un = -1;
      {
        const int i = clampi(uproto, 0, s.NUP - 1);
        const int* UK = T(T_UPROTO_KEY) + i * 8;
        bool km = true, kz = true;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          km = km && UK[j] == key[j];
          kz = kz && UK[j] == 0;
        }
        if (uproto >= 0 && T(T_UPROTO_MIN_AGENTS)[i] <= n_agents && (km || kz)) p_un = i;
      }
      const int p_idx = clipped ? p_un : p_norm;
      ok = ok && p_idx >= 0;
      const int pn = clampi(p_idx, 0, s.NP - 1), pu = clampi(p_idx, 0, s.NUP - 1);
      auto pick = [&](int tn, int tu, int stride, int j) {
        return clipped ? T(tu)[pu * stride + j] : T(tn)[pn * stride + j];
      };
      cooldown = pick(T_PROTO_COOLDOWN, T_UPROTO_COOLDOWN, 1, 0);
      const int nvibes = pick(T_PROTO_NVIBES, T_UPROTO_NVIBES, 1, 0);

      // neighbour order: agents by rotation from the actor's slot, then the
      // other slots, both stable in slot order
      int rank_inb[8], run = 0, start = 0;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        run += inb[o];
        rank_inb[o] = run - 1;
        if (NEIGHBOR_OFFS[o][0] == cur_r - sr && NEIGHBOR_OFFS[o][1] == cur_c - sc)
          start += rank_inb[o];
      }
      const int nim = max(run, 1);
      int okey[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int x = (rank_inb[o] - start) % nim;
        okey[o] = isag[o] ? (x < 0 ? x + nim : x) : 1000 + o;
      }
      int ref_idx[8], v8[8];
      bool ref_valid[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int pos = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) pos += okey[k] < okey[j] || (okey[k] == okey[j] && k < j);
#pragma unroll
        for (int p = 0; p < 8; ++p)
          if (p == pos) {
            ref_idx[p] = nidx[j];
            ref_valid[p] = isag[j];
            v8[p] = nvib[j];
          }
      }

      // output slots: the occurrence index of each slot's vibe among the
      // earlier slots against the protocol's count of that vibe
      bool sel[8], any_sel = false;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int vc = clampi(v8[p], 0, V - 1);
        int occ = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) occ += q < p && clampi(v8[q], 0, V - 1) == vc;
        sel[p] = ref_valid[p] && v8[p] != 0 &&
                 occ < pick(T_PROTO_VIBE_COUNTS, T_UPROTO_VIBE_COUNTS, V, vc);
        any_sel = any_sel || sel[p];
      }
      const bool use_multi = nvibes > 1 && any_sel;
      int out_idx[8];
      bool out_valid[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        out_valid[p] = use_multi ? sel[p] : p == 0;
        out_idx[p] = use_multi ? ref_idx[p] : lane;
      }

      const int* PRES = T(T_PROTO_RES);
      bool has_output = false, can_absorb = false;
      for (int ri = 0; ri < s.n_pres; ++ri) {
        const int r = PRES[ri];
        const int need = pick(T_PROTO_IN, T_UPROTO_IN, R, r);
        const int give = pick(T_PROTO_OUT, T_UPROTO_OUT, R, r);
        int total = 0, total_free = 0;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          if (ref_valid[p]) total += s_inv[ref_idx[p] * R + r];
          if (out_valid[p]) {
            const int q = out_idx[p] * R + r;
            total_free += max(LIM[q] - s_inv[q], 0);
          }
        }
        ok = ok && (need == 0 || total >= need);
        has_output = has_output || give > 0;
        can_absorb = can_absorb || (give > 0 && total_free >= 1);
      }
      ok = ok && (!has_output || can_absorb || clipped);

      // shared_update on local slot copies: spread `delta` of resource r over
      // the valid slots, three kick passes, then base + sign-surplus to the
      // earliest actives; each slot's delta goes to its agent's buffer row
      auto consume = [&](const int* idx, const bool* valid, int delta, int r) {
        int cur[8], lim[8], app[8];
        bool act[8];
        int n = 0;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const int q = idx[o] * R + r;
          cur[o] = valid[o] ? s_inv[q] : 0;
          lim[o] = valid[o] ? LIM[q] : 0;
          app[o] = 0;
          act[o] = valid[o] && delta != 0;
          n += act[o];
        }
        int rem = delta;
        for (int pass = 0; pass < 3; ++pass) {
          const int per = n > 0 ? rem / max(n, 1) : 0;  // C division truncates
          const bool pos = rem > 0;
          int took = 0, kicked = 0;
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            const int fr = max(lim[o] - cur[o], 0);
            const bool kick = act[o] && (pos ? fr - app[o] <= per : cur[o] + app[o] <= -per);
            const int take = min(max(kick ? per : 0, -(cur[o] + app[o])), fr - app[o]);
            app[o] += take;
            took += take;
            kicked += kick;
            act[o] = act[o] && !kick;
          }
          rem -= took;
          n -= kicked;
        }
        const int base = n > 0 ? rem / max(n, 1) : 0;
        const int surplus = rem - base * n;
        const int sgn = (surplus > 0) - (surplus < 0);
        const int sab = surplus < 0 ? -surplus : surplus;
        int rl = -1;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          rl += act[o];
          int fin = act[o] ? base + (rl < sab ? sgn : 0) : 0;
          fin = min(max(fin, -(cur[o] + app[o])), max(lim[o] - cur[o], 0) - app[o]);
          if (valid[o] && app[o] + fin) atomicAdd(&s_acc[idx[o] * R + r], app[o] + fin);
        }
      };
      if (ok)
        for (int ri = 0; ri < s.n_pres; ++ri) {
          const int r = PRES[ri];
          consume(ref_idx, ref_valid, -pick(T_PROTO_IN, T_UPROTO_IN, R, r), r);
          consume(out_idx, out_valid, pick(T_PROTO_OUT, T_UPROTO_OUT, R, r), r);
        }
    }
    __syncwarp();
    apply_acc(true);
    s_st[lane] = (is_winner && ok) ? st : -1;
    s_cd[lane] = cooldown;
    __syncwarp();
    // station write-back: each claimed station has one winner
    const unsigned claimed = __ballot_sync(FULL, is_winner && ok);
    for (int i = lane; i < NA; i += 32) {
      for (unsigned m = claimed; m; m &= m - 1) {
        const int t = __ffs(m) - 1;
        if (s_st[t] != i) continue;
        const bool was_clipped = in.asm_clipped[eNA + i] != 0;
        out.asm_cd_dur[eNA + i] = s_cd[t];
        out.asm_cd_end[eNA + i] = step + s_cd[t];
        if (!was_clipped) out.asm_uses[eNA + i] = in.asm_uses[eNA + i] + 1;
        out.asm_clipped[eNA + i] = 0;
        if (was_clipped) out.asm_uproto[eNA + i] = -1;
      }
    }
    success = success || (is_winner && ok);
  }

  // ---------- action resource consumption ----------
  if (s.any_consumed) {
    zero_acc();
    if (live && success)
      for (int r = 0; r < R; ++r) s_acc[arow + r] = -T(T_ACTION_CONSUMED)[act * R + r];
    __syncwarp();
    apply_acc(true);
  }

  // ---------- outputs ----------
  if (live) {
    out.r[ea] = cur_r;
    out.c[ea] = cur_c;
    out.vibe[ea] = vibe;
    out.frozen[ea] = frozen;
    out.success[ea] = success ? 1 : 0;
    out.executed[ea] = success ? act : 0;
  }
  for (int i = lane; i < AR; i += 32) {
    out.inv[eAR + i] = s_inv[i];
    if (s.track_gained) {
      out.gained[eAR + i] = in.gained[eAR + i] + s_gain[i];
      out.lost[eAR + i] = in.lost[eAR + i] + s_lost[i];
    }
  }
#undef T
}

}  // namespace

// Launches the span on `stream`: `ins` and `outs` are the device pointers in
// the order of In and Out, `st` the config's statics, `tab` the table pack.
// Returns cudaGetLastError() (0 = launched).
extern "C" int sim_fused_launch(const void* const* ins, void* const* outs, const void* statics,
                                const void* tab, int E, void* stream) {
  const Static* st = (const Static*)statics;
  In in;
  Out out;
  static_assert(sizeof(In) == N_IN * sizeof(void*), "In is a list of pointers");
  static_assert(sizeof(Out) == N_OUT * sizeof(void*), "Out is a list of pointers");
  memcpy(&in, ins, sizeof(In));
  memcpy(&out, outs, sizeof(Out));
  const size_t smem = (size_t)ENVS_PER_BLOCK * warp_ints(st->A, st->R) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sim_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (E + ENVS_PER_BLOCK - 1) / ENVS_PER_BLOCK;
  sim_fused_kernel<<<blocks, 32 * ENVS_PER_BLOCK, smem, (cudaStream_t)stream>>>(
      in, out, *st, (const int32_t*)tab, E);
  return (int)cudaGetLastError();
}
