// Fused interaction span of the batched step for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces metta_tpu/ops/sim_fused.py:150, the inner `kernel` of
// build_fused_kernel (the Pallas TPU kernel behind call_fused and
// fused_step_full). Same function: decode, change_vibe, vibe-triggered attack
// and transfer, swaps with frozen agents, the four rank-arbitrated move
// rounds, the assembler phase, the chest phase and action consumption,
// byte-identical to the plain torch version
// metta_tpu_torch/engine/step_batched.py:interaction_span.
//
// What bounds it: instruction issue, per warp. At E=4096 on the combat map
// the span moves 25 MB (7.4 us at 3.35 TB/s, ops/sim_fused.py:span_work), but
// each env is one warp's serial chain of a few thousand instructions, and a
// wave of 31 warps an SM issues them. On the section ablation's input
// (metta_tpu_torch/scripts/ablate_fused.py, an H100 at 700 W) this design
// takes 0.032 ms: 0.022 with every optional section off, the assembler
// phase 0.008, the attack 0.006. The first design took 0.103 ms there
// (0.041 with the sections off, the assembler phase 0.049): a warp walked A
// lanes with two shuffles per candidate for each of seven per-key winners
// and three per agent in each of four move rounds, and read every table from
// device memory inside loops whose bounds were runtime fields.
//
// Design: one warp per env, lane = agent (A <= kMaxA = 32); a persistent
// grid of blocks of up to kMaxWarps warps, as many blocks as the SMs hold,
// warp w of the grid taking envs w, w + nw, ... (nw warps in the grid).
//   - Sections are template parameters (has_attack, has_transfer, has_swap,
//     has_asm, has_chest): the launcher picks the instantiation the config
//     needs. The chest section is instantiated only beside the assembler
//     section (every config with chests in the repository has assemblers;
//     ops/sim_fused.py:size_faults sends the others to the torch-ops step).
//   - The table pack is loaded into shared memory once per block, with the
//     agents' limits at an odd row stride; every table read is a shared load.
//   - Loops over resources are unrolled to kMaxR with a runtime guard.
//   - A winner per key (target agent, target cell, station) is two warp
//     instructions: __match_any_sync on the key gives the lane's group, and
//     __reduce_min_sync of the score (rank for a candidate, A + 1 otherwise)
//     over that group's mask gives the group's lowest rank.
//   - The move rounds read the agents' current (r, c) pairs from
//     warp-private shared memory in 16-byte broadcast loads, no shuffles, and
//     stop as soon as no mover is unresolved.
//   - The assembler phase walks the env's winning stations in turn, the
//     whole warp on each: eight ballots give each neighbour cell's agent;
//     a lane per neighbour slot finds, by eight shuffles, its place in the
//     sorted vibe key and in the neighbour order and writes it to the warp's
//     slot arrays; a lane per protocol makes the pick (reduce and ballot), a
//     lane per place its output test, and a lane per (resource, input or
//     output) pass the resource checks and the shared consume.
//   - The chest phase finds one winner per chest with the same per-key
//     winner as the stations; each winner, on its own lane, moves its vibe's
//     deposits and withdrawals between its own row and its chest's row in
//     device memory (a chest has one winner, a winner one chest), so it
//     needs no atomics. Every chest's inventory passes through, clipped to
//     0..65535 as the plain version clips every chest.
// Sums into other agents' rows stay integer atomics into shared memory: an
// integer sum is the same in any order, so results stay byte-exact. Every
// phase adds its deltas to a buffer, and each lane then clamps its own row
// once, as the plain version's one clamp per phase does; a phase with no
// delta skips its clamp once a clamp has put every row in range.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxA = 32;       // agents: a lane each
constexpr int kMaxR = 16;       // resources: loops unrolled to this
constexpr int kMaxNP = 32;      // protocols: a lane each in the pick
constexpr int kMaxWarps = 8;    // envs (warps) a block holds at once
constexpr int kThreads = 32 * kMaxWarps;

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
  T_CHEST_VIBE_DELTA, T_CHEST_VIBE_HAS, T_CHEST_LIMS,
  N_TAB
};

// Sizes and statics of one config; ops/sim_fused.py:_Static mirrors it.
struct Static {
  int A, R, V, H, W, NACT, NA, NP, NUP, n_loot, n_pres;
  int has_attack, has_transfer, has_swap, has_asm, track_gained, any_consumed;
  int defense_any, attack_freeze;
  int act_noop, act_move, act_change_vibe, kind_asm;
  int NC, NT, has_chest, kind_chest;
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
  const int32_t *chest_inv, *chest_type;  // null without chests
  const uint8_t* chest_valid;
};

// Outputs, in the order of ops/sim_fused.py:_OUT.
struct Out {
  int32_t *r, *c, *vibe, *frozen, *inv, *gained, *lost;
  int32_t *asm_cd_dur, *asm_cd_end, *asm_uses;
  uint8_t* asm_clipped;
  int32_t* asm_uproto;
  uint8_t* success;
  int32_t* executed;
  int32_t* chest_inv;  // null without chests
};

constexpr int N_IN = 25;
constexpr int N_OUT = 15;

// Shared memory, in ints, each region a multiple of 4: the table pack, the
// limits [A][RS] (RS = R | 1, an odd stride: a warp's lanes reading their own
// rows hit distinct banks), then per warp: inventories and the delta buffer
// [A][RS] (and gained, lost where tracked), positions [32] as (r, c) pairs,
// ranks [32], three sums [3][32], and a station's sorted vibe key [8], the
// agents of its neighbour order [8] and their vibes [8].
// ops/sim_fused.py:span_smem_bytes mirrors it.
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int row_stride(int R) { return R | 1; }
__host__ __device__ inline int warp_ints(int A, int R, int track) {
  return round4((track ? 4 : 2) * A * row_stride(R)) + 2 * 32 + 32 + 3 * 32 + 3 * 8;
}
__host__ __device__ inline int block_ints(int n_tab, int A, int R, int track, int warps) {
  return round4(n_tab) + round4(A * row_stride(R)) + warps * warp_ints(A, R, track);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The eight neighbour offsets of a cell, in slot order (protocols.py:NEIGHBOR_OFFS).
__device__ __forceinline__ constexpr int nb_dr(int o) { return o < 3 ? -1 : (o < 5 ? 0 : 1); }
__device__ __forceinline__ constexpr int nb_dc(int o) {
  return o < 3 ? o - 1 : (o == 3 ? -1 : (o == 4 ? 1 : o - 6));
}

// Whether this lane is its key group's candidate of lowest rank: `group` is
// __match_any_sync of the key, the same mask on every lane it names.
__device__ __forceinline__ bool lowest_rank(bool cand, int rank, int A, unsigned group) {
  const int score = cand ? rank : A + 1;
  const int best = __reduce_min_sync(group, score);  // every lane, outside the &&
  return cand && score == best;
}

// shared_update on local slot copies, a lane per place: each group of 8
// lanes (places 0-7) spreads `delta` of resource r over its valid places:
// three kick passes, then base + sign-surplus to the earliest actives. The
// lane's place holds agent `agent`'s row (`valid`: an agent stands there);
// its delta goes to that agent's buffer row. Every lane calls it: the sums
// are shuffles and ballots within the group.
__device__ __forceinline__ void consume(bool valid, int agent, int delta, int r,
                                        const int* s_inv, const int* s_lim, int* s_acc, int RS) {
  const int lane = threadIdx.x & 31;
  const unsigned group = 0xffu << (lane & 24), below = group & ((1u << lane) - 1);
  const int q = agent * RS + r;
  const int cur = valid ? s_inv[q] : 0;
  const int fr = valid ? max(s_lim[q] - cur, 0) : 0;
  int app = 0;
  bool act = valid && delta != 0;
  int n = __popc(__ballot_sync(FULL, act) & group);
  int rem = delta;
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const int per = n > 0 ? rem / max(n, 1) : 0;  // C division truncates, as trunc_div
    const bool kick = act && (rem > 0 ? fr - app <= per : cur + app <= -per);
    const int take = min(max(kick ? per : 0, -(cur + app)), fr - app);
    app += take;
    int took = take;
    took += __shfl_xor_sync(FULL, took, 1);
    took += __shfl_xor_sync(FULL, took, 2);
    took += __shfl_xor_sync(FULL, took, 4);
    rem -= took;
    n -= __popc(__ballot_sync(FULL, kick) & group);
    act = act && !kick;
  }
  const int base = n > 0 ? rem / max(n, 1) : 0;
  const int surplus = rem - base * n;
  const int sgn = (surplus > 0) - (surplus < 0);
  const int sab = surplus < 0 ? -surplus : surplus;
  const int rl = __popc(__ballot_sync(FULL, act) & below);  // actives before this place
  int fin = act ? base + (rl < sab ? sgn : 0) : 0;
  fin = min(max(fin, -(cur + app)), fr - app);
  if (valid && app + fin) atomicAdd(&s_acc[q], app + fin);
}

// The span of env e, on one warp. `s_tab`/`s_lim` are the block's tables,
// `w_base` the warp's own shared arrays.
template <bool ATTACK, bool TRANSFER, bool SWAP, bool ASM, bool CHEST>
__device__ __forceinline__ void env_span(int e, const In& in, const Out& out, const Static& s,
                                         const int* s_tab, const int* s_lim, int* w_base) {
  const int lane = threadIdx.x & 31;
  const int A = s.A, R = s.R, V = s.V, H = s.H, W = s.W, NA = s.NA;
  const int RS = row_stride(R);
  const bool track = s.track_gained != 0;
  int* s_inv = w_base;
  int* s_acc = s_inv + A * RS;
  int* s_gain = s_acc + A * RS;
  int* s_lost = s_gain + A * RS;
  int2* s_pos = reinterpret_cast<int2*>(w_base + round4((track ? 4 : 2) * A * RS));
  int* s_rank = reinterpret_cast<int*>(s_pos + 32);
  int* s_sum = s_rank + 32;
  int* s_key = s_sum + 3 * 32;
  int* s_ref = s_key + 8;
  int* s_v8 = s_ref + 8;
#define TAB(name) (s_tab + s.off[name])

  const bool live = lane < A;
  const int a = live ? lane : 0;
  const int arow = a * RS;
  const size_t ea = (size_t)e * A + a;
  const size_t eAR = ea * R;
  const size_t eNA = (size_t)e * NA;
  const int step = __ldg(in.step + e);

  const int act_in = live ? __ldg(in.actions + ea) : -1;
  const int rank = live ? __ldg(in.rank + ea) : A + 1 + lane;
  const int r0 = live ? __ldg(in.r + ea) : 0;
  const int c0 = live ? __ldg(in.c + ea) : 0;
  const int frozen0 = live ? __ldg(in.frozen + ea) : 0;
  int vibe = live ? __ldg(in.vibe + ea) : 0;
  if (live) {
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      s_inv[arow + r] = __ldg(in.inv + eAR + r);
      s_acc[arow + r] = 0;
      if (track) {
        s_gain[arow + r] = 0;
        s_lost[arow + r] = 0;
      }
    }
  }
  // station fields pass through; the winners overwrite their claimed stations
  for (int i = lane; i < NA; i += 32) {
    out.asm_cd_dur[eNA + i] = __ldg(in.asm_cd_dur + eNA + i);
    out.asm_cd_end[eNA + i] = __ldg(in.asm_cd_end + eNA + i);
    out.asm_uses[eNA + i] = __ldg(in.asm_uses + eNA + i);
    out.asm_clipped[eNA + i] = __ldg(in.asm_clipped + eNA + i);
    out.asm_uproto[eNA + i] = __ldg(in.asm_uproto + eNA + i);
  }
  if (CHEST) {  // every chest's row passes through; the winners overwrite theirs
    const size_t eCR = (size_t)e * s.NC * R;
    for (int i = lane; i < s.NC * R; i += 32)
      out.chest_inv[eCR + i] = clampi(__ldg(in.chest_inv + eCR + i), 0, 65535);
  }
  __syncwarp();

  // clamp own row of inv + acc into [0, lim] and zero acc; gained/lost from
  // the net change. Once every row is in range, a phase with no delta skips it.
  bool clamped = false;
  auto apply = [&](bool any_delta, bool track_net) {
    if (clamped && !any_delta) return;  // warp-uniform
    clamped = true;
    if (live) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r >= R) break;
        const int old = s_inv[arow + r];
        const int nw = min(max(old + s_acc[arow + r], 0), s_lim[arow + r]);
        s_inv[arow + r] = nw;
        s_acc[arow + r] = 0;
        if (track) {
          if (track_net) s_gain[arow + r] += max(nw - old, 0);
          s_lost[arow + r] += max(old - nw, 0);
        }
      }
    }
    __syncwarp();
  };

  // ---------- decode ----------
  const int NACT = s.NACT;
  const bool act_ok = live && act_in >= 0 && act_in < NACT;
  const int act = clampi(act_in, 0, NACT - 1);
  const int kind = TAB(T_ACTION_KIND)[act];
  const int arg = TAB(T_ACTION_ARG)[act];
  const bool is_frozen = frozen0 != 0;
  int frozen = (act_ok && is_frozen && frozen0 > 0) ? frozen0 - 1 : frozen0;
  bool has_req = true;
  {
    const int* REQ = TAB(T_ACTION_REQUIRED) + act * R;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      has_req = has_req && s_inv[arow + r] >= REQ[r];
    }
  }
  const bool attempt = act_ok && !is_frozen && has_req;
  bool success = attempt && kind == s.act_noop;

  // ---------- change_vibe ----------
  const bool cv = attempt && kind == s.act_change_vibe;
  if (cv) vibe = arg;
  success = success || cv;

  // ---------- movement proposals ----------
  bool movers = attempt && kind == s.act_move;
  const int a8 = clampi(arg, 0, 7);
  const int r1 = r0 + TAB(T_MOVE_DELTAS)[2 * a8];
  const int c1 = c0 + TAB(T_MOVE_DELTAS)[2 * a8 + 1];
  movers = movers && r1 >= 0 && r1 < H && c1 >= 0 && c1 < W;
  const int flat = clampi(r1, 0, H - 1) * W + clampi(c1, 0, W - 1);
  int skind = 0, sidx = 0, occ0 = 0;
  if (movers) {
    const size_t g = (size_t)e * H * W + flat;
    skind = __ldg(in.static_kind + g);
    sidx = __ldg(in.static_idx + g);
    occ0 = __ldg(in.agent_grid + g);
  }
  const bool has_tgt = movers && occ0 > 0;
  const int tgt = has_tgt ? occ0 - 1 : 0;
  const int vibe_c = clampi(vibe, 0, V - 1);

  auto from_t = [&](int x) {
    const int v = __shfl_sync(FULL, x, tgt);
    return has_tgt ? v : 0;
  };
  unsigned by_tgt = 0;  // lanes of the same target agent
  if (ATTACK || TRANSFER || SWAP) by_tgt = __match_any_sync(FULL, tgt);

  // ---------- vibe-triggered attacks ----------
  bool handled_attack = false;
  if (ATTACK) {
    const int* AC = TAB(T_ATTACK_CONSUMED);
    const int* WW = TAB(T_ATTACK_WEAPON_W);
    const int* AW = TAB(T_ATTACK_ARMOR_W);
    const bool wants = movers && TAB(T_ATTACK_VIBE_MASK)[vibe_c] && has_tgt;
    bool afford = true;
    int weapon = 0;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      const int x = s_inv[arow + r];
      afford = afford && x >= AC[r];
      weapon += x * WW[r];
    }
    const bool t_free = from_t(frozen) <= 0;
    const bool valid = lowest_rank(wants && t_free && afford, rank, A, by_tgt);

    const int t_vibe = from_t(vibe_c);
    const int vb = TAB(T_ATTACK_VIBE_BONUS)[t_vibe];
    const int* VMR = TAB(T_VIBE_MATCHES_RESOURCE) + t_vibe * R;
    const int trow = tgt * RS;
    int armor = 0;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      const int it = has_tgt ? s_inv[trow + r] : 0;
      armor += (it + (VMR[r] ? vb : 0)) * AW[r];
    }
    const int bonus = max(weapon - armor, 0);

    bool blocked = false;
    if (s.defense_any) {
      const int* DEF = TAB(T_ATTACK_DEFENSE);
      const int* DM = TAB(T_ATTACK_DEFENSE_MASK);
      bool can_defend = true;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r >= R) break;
        const int it = has_tgt ? s_inv[trow + r] : 0;
        can_defend = can_defend && (!DM[r] || it >= DEF[r] + bonus);
      }
      blocked = valid && can_defend;
      if (blocked && has_tgt) {
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r >= R) break;
          if (DM[r]) atomicAdd(&s_acc[trow + r], -(DEF[r] + bonus));
        }
      }
      const bool any = __any_sync(FULL, blocked && has_tgt);
      __syncwarp();
      apply(any, false);  // the defense clamp tracks only `lost`
    }

    const bool hit = valid && !blocked;
    if (s.attack_freeze > 0) {
      s_sum[lane] = 0;
      __syncwarp();
      if (hit && has_tgt) atomicAdd(&s_sum[tgt], 1);
      __syncwarp();
      frozen += s.attack_freeze * s_sum[lane];
      __syncwarp();
    }
    if (live) {
      const int* AAD = TAB(T_ATTACK_ACTOR_DELTA);
      const int* ATD = TAB(T_ATTACK_TARGET_DELTA);
      const int* LOOT = TAB(T_LOOT);
      if (hit) {
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r >= R) break;
          if (AAD[r]) atomicAdd(&s_acc[arow + r], AAD[r]);
          if (has_tgt && ATD[r]) atomicAdd(&s_acc[trow + r], ATD[r]);
        }
        for (int li = 0; li < s.n_loot; ++li) {
          const int rl = LOOT[li];
          const int amount = has_tgt ? s_inv[trow + rl] : 0;
          const int space = max(s_lim[arow + rl] - s_inv[arow + rl], 0);
          const int stolen = min(amount, space);
          if (stolen) {
            atomicAdd(&s_acc[arow + rl], stolen);
            if (has_tgt) atomicAdd(&s_acc[trow + rl], -stolen);
          }
        }
      }
      if (valid) {
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r >= R) break;
          if (AC[r]) atomicAdd(&s_acc[arow + r], -AC[r]);
        }
      }
    }
    const bool any = __any_sync(FULL, valid);
    __syncwarp();
    apply(any, true);
    success = success || valid;
    handled_attack = valid;
  }

  // ---------- vibe-triggered transfers ----------
  bool handled_tr = false;
  if (TRANSFER) {
    const int* TAD = TAB(T_TRANSFER_ACTOR_DELTA) + vibe_c * R;
    const int* TTD = TAB(T_TRANSFER_TARGET_DELTA) + vibe_c * R;
    const int* TREQ = TAB(T_TRANSFER_REQUIRED);
    const bool wants = movers && !handled_attack && TAB(T_TRANSFER_VIBE_MASK)[vibe_c] && has_tgt;
    bool req_ok = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      req_ok = req_ok && s_inv[arow + r] >= TREQ[r];
    }
    const bool t_free = from_t(frozen) <= 0;
    bool ok = lowest_rank(wants && t_free && req_ok, rank, A, by_tgt);
    const int trow = tgt * RS;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      const int da = TAD[r], dt = TTD[r];
      const int inv_a = s_inv[arow + r];
      const int free_a = max(s_lim[arow + r] - inv_a, 0);
      const int inv_t = has_tgt ? s_inv[trow + r] : 0;
      const int free_t = has_tgt ? max(s_lim[trow + r] - inv_t, 0) : 0;
      ok = ok && (da >= 0 || inv_a >= -da) && (dt >= 0 || inv_t >= -dt) &&
           (da <= 0 || da <= free_a) && (dt <= 0 || dt <= free_t);
    }
    if (ok) {
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r >= R) break;
        if (TAD[r]) atomicAdd(&s_acc[arow + r], TAD[r]);
        if (has_tgt && TTD[r]) atomicAdd(&s_acc[trow + r], TTD[r]);
      }
    }
    const bool any = __any_sync(FULL, ok);
    __syncwarp();
    apply(any, true);
    success = success || ok;
    handled_tr = ok;
  }

  // ---------- swaps with frozen agents ----------
  bool handled_station = false;
  int cur_r = r0, cur_c = c0;
  if (SWAP) {
    const int t_frozen = from_t(frozen);  // every lane shuffles, outside the &&
    const bool wants = movers && !handled_attack && !handled_tr && has_tgt && t_frozen > 0;
    const bool swap_ok = lowest_rank(wants, rank, A, by_tgt);
    const int t_r = from_t(r0), t_c = from_t(c0);
    if (__any_sync(FULL, swap_ok)) {  // warp-uniform
      // the swappers' counts and positions summed into their targets
      s_sum[lane] = 0;
      s_sum[32 + lane] = 0;
      s_sum[64 + lane] = 0;
      __syncwarp();
      if (swap_ok && has_tgt) {
        atomicAdd(&s_sum[tgt], 1);
        atomicAdd(&s_sum[32 + tgt], r0);
        atomicAdd(&s_sum[64 + tgt], c0);
      }
      __syncwarp();
      const bool swapped_in = s_sum[lane] > 0;
      const int in_r = s_sum[32 + lane], in_c = s_sum[64 + lane];
      __syncwarp();
      if (swap_ok) {
        cur_r = t_r;
        cur_c = t_c;
      }
      if (swapped_in) {
        cur_r = in_r;
        cur_c = in_c;
      }
    }
    success = success || swap_ok;
    handled_station = wants;
  }
  const bool interacted = handled_attack || handled_tr || handled_station;

  // ---------- plain moves: rank-arbitrated rounds ----------
  bool unresolved = movers && !interacted && skind == 0;
  bool moved = false;
  if (__any_sync(FULL, unresolved)) {  // warp-uniform
    const unsigned by_cell = __match_any_sync(FULL, flat);
    s_pos[lane] = live ? make_int2(cur_r, cur_c) : make_int2(-1, -1);  // never a target
    s_rank[lane] = rank;
    __syncwarp();
    for (int round = 0; round < 4; ++round) {
      const unsigned un_mask = __ballot_sync(FULL, unresolved);
      if (!un_mask) break;  // nothing left to resolve: the rounds change nothing more
      const unsigned waiting = un_mask | __ballot_sync(FULL, moved);
      bool occ_any = false, blocker = false;
      if (unresolved) {
        // another agent at my target: blocked by a later rank or by one that resolved
#pragma unroll
        for (int t = 0; t < kMaxA; t += 2) {
          if (t >= A) break;
          const int4 p = *reinterpret_cast<const int4*>(s_pos + t);
          const int2 k = *reinterpret_cast<const int2*>(s_rank + t);
          if (t != lane && p.x == r1 && p.y == c1) {
            occ_any = true;
            blocker = blocker || k.x > rank || !((waiting >> t) & 1u);
          }
          if (t + 1 != lane && p.z == r1 && p.w == c1) {
            occ_any = true;
            blocker = blocker || k.y > rank || !((waiting >> (t + 1)) & 1u);
          }
        }
      }
      __syncwarp();  // every lane has read the round's positions
      unresolved = unresolved && !blocker;
      const bool wins = lowest_rank(unresolved, rank, A, by_cell) && !occ_any;
      if (wins) {
        cur_r = r1;
        cur_c = c1;
        s_pos[lane] = make_int2(r1, c1);
      }
      moved = moved || wins;
      unresolved = unresolved && !wins;
      __syncwarp();
    }
  }
  success = success || moved;

  // ---------- assembler phase: the env's winning stations in turn ----------
  if (ASM) {
    const bool bump = movers && !interacted && skind == s.kind_asm;
    const int st = clampi(sidx, 0, NA - 1);
    const bool is_winner = lowest_rank(bump, rank, A, __match_any_sync(FULL, st));
    unsigned winners = __ballot_sync(FULL, is_winner);
    int w_type = 0, w_ok = 0, w_clip = 0, w_uproto = 0, w_sr = 0, w_sc = 0;
    if (is_winner) {
      const size_t es = eNA + st;
      w_type = __ldg(in.asm_type + es);
      w_clip = __ldg(in.asm_clipped + es) != 0;
      w_uproto = __ldg(in.asm_uproto + es);
      w_sr = __ldg(in.asm_r + es);
      w_sc = __ldg(in.asm_c + es);
      const int uses = __ldg(in.asm_uses + es);
      const int max_uses = TAB(T_TYPE_MAX_USES)[w_type];
      w_ok = __ldg(in.asm_valid + es) != 0 && (max_uses == 0 || uses < max_uses) &&
             max(__ldg(in.asm_cd_end + es) - step, 0) == 0;
    }
    const bool any_winner = winners != 0;
    bool my_ok = false;
    int my_cd = 0;
    const int j = lane & 7;                // lane j (and j + 8, ...): neighbour slot j
    const bool res_lane = lane < s.n_pres;  // lane i checks resource PRES[i]
    const int res = res_lane ? TAB(T_PROTO_RES)[lane] : 0;
    while (winners) {  // warp-uniform
      const int w = __ffs(winners) - 1;
      winners &= winners - 1;
      const int sr = __shfl_sync(FULL, w_sr, w), sc = __shfl_sync(FULL, w_sc, w);
      const int s_type = __shfl_sync(FULL, w_type, w);
      const bool clipped = __shfl_sync(FULL, w_clip, w) != 0;
      const int uproto = __shfl_sync(FULL, w_uproto, w);
      const int wr = __shfl_sync(FULL, cur_r, w), wc = __shfl_sync(FULL, cur_c, w);
      const bool ok0 = __shfl_sync(FULL, w_ok, w) != 0;

      // slot j's agent, from the agents' final positions: one ballot per slot
      const int dr = cur_r - sr, dc = cur_c - sc;
      const int o9 = (dr + 1) * 3 + (dc + 1);
      const int my_slot = (live && dr >= -1 && dr <= 1 && dc >= -1 && dc <= 1 && o9 != 4)
                              ? o9 - (o9 > 4) : -1;
      unsigned mj = 0;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const unsigned m = __ballot_sync(FULL, my_slot == o);
        if (o == j) mj = m;
      }
      const int rr = sr + nb_dr(j), cc = sc + nb_dc(j);
      const bool inb_j = rr >= 0 && rr < H && cc >= 0 && cc < W;
      const bool ag_j = inb_j && mj != 0;
      const int nidx_j = ag_j ? __ffs(mj) - 1 : 0;
      const int vib = __shfl_sync(FULL, vibe, nidx_j);
      const int nvib_j = ag_j ? vib : 0;
      const unsigned inb = __ballot_sync(FULL, lane < 8 && inb_j);    // bit j: slot j
      const unsigned isag = __ballot_sync(FULL, lane < 8 && ag_j);
      const int n_agents = __popc(isag);

      // slot j's place in the sorted vibe key (out-of-range vibes sort as V)
      // and in the neighbour order: agents by rotation from the winner's
      // slot, then the other slots, both stable in slot order
      const int x = (nvib_j >= 0 && nvib_j < V) ? nvib_j : V;
      const int rank_inb = __popc(inb & ((2u << j) - 1)) - 1;
      const bool w_slot = nb_dr(j) == wr - sr && nb_dc(j) == wc - sc;
      const int start = __reduce_add_sync(FULL, (lane < 8 && w_slot) ? rank_inb : 0);
      const int nim = max(__popc(inb), 1);
      const int rot = (rank_inb - start) % nim;
      const int okey = ag_j ? (rot < 0 ? rot + nim : rot) : 1000 + j;
      int kpos = 0, opos = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int xk = __shfl_sync(FULL, x, k), okk = __shfl_sync(FULL, okey, k);
        kpos += xk < x || (xk == x && k < j);
        opos += okk < okey || (okk == okey && k < j);
      }
      if (lane < 8) {
        s_key[kpos] = x;
        s_ref[opos] = ag_j ? nidx_j : -1;  // -1: no agent in the slot
        s_v8[opos] = nvib_j;
      }
      __syncwarp();

      // protocol: exact key, else the empty key; highest proto_rank, first
      // wins; lane p checks protocol p
      int sc_e = -1, sc_0 = -1;
      if (lane < s.NP) {
        const int* PK = TAB(T_PROTO_KEY) + lane * 8;
        const bool cand = TAB(T_PROTO_VALID)[lane] && TAB(T_PROTO_TYPE)[lane] == s_type &&
                          TAB(T_PROTO_MIN_AGENTS)[lane] <= n_agents;
        bool exact = true, zero = true;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          exact = exact && PK[k] == s_key[k];
          zero = zero && PK[k] == 0;
        }
        const int pr = TAB(T_PROTO_RANK)[lane];
        sc_e = cand && exact ? pr : -1;
        sc_0 = cand && zero ? pr : -1;
      }
      const int best_e = __reduce_max_sync(FULL, sc_e);
      const int best_0 = __reduce_max_sync(FULL, sc_0);
      const unsigned be = __ballot_sync(FULL, best_e >= 0 && sc_e == best_e);
      const unsigned b0 = __ballot_sync(FULL, best_0 >= 0 && sc_0 == best_0);
      const int p_norm = be ? __ffs(be) - 1 : (b0 ? __ffs(b0) - 1 : -1);
      int p_un = -1;
      {
        const int i = clampi(uproto, 0, s.NUP - 1);
        const int* UK = TAB(T_UPROTO_KEY) + i * 8;
        bool km = true, kz = true;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          km = km && UK[k] == s_key[k];
          kz = kz && UK[k] == 0;
        }
        if (uproto >= 0 && TAB(T_UPROTO_MIN_AGENTS)[i] <= n_agents && (km || kz)) p_un = i;
      }
      const int p_idx = clipped ? p_un : p_norm;
      const int pn = clampi(p_idx, 0, s.NP - 1), pu = clampi(p_idx, 0, s.NUP - 1);
      auto pick = [&](int tn, int tu, int stride, int k) {
        return clipped ? TAB(tu)[pu * stride + k] : TAB(tn)[pn * stride + k];
      };
      const int cooldown = pick(T_PROTO_COOLDOWN, T_UPROTO_COOLDOWN, 1, 0);
      const int nvibes = pick(T_PROTO_NVIBES, T_UPROTO_NVIBES, 1, 0);

      // output slots: lane p takes place p of the order; the occurrence index
      // of its vibe among the earlier places against the protocol's count
      const int ref_p = s_ref[j];
      const int vc = clampi(s_v8[j], 0, V - 1);
      int occ = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) occ += q < j && clampi(s_v8[q], 0, V - 1) == vc;
      const bool sel_p = ref_p >= 0 && s_v8[j] != 0 &&
                         occ < pick(T_PROTO_VIBE_COUNTS, T_UPROTO_VIBE_COUNTS, V, vc);
      const unsigned ref_valid = __ballot_sync(FULL, lane < 8 && ref_p >= 0);
      const unsigned sel = __ballot_sync(FULL, lane < 8 && sel_p);
      const bool use_multi = nvibes > 1 && sel != 0;
      const unsigned out_valid = use_multi ? sel : 1u;
      const int single = use_multi ? -1 : w;  // the output's one agent, else the places'

      // resources: lane i checks resource PRES[i]
      int need = 0, give = 0, total = 0, total_free = 0;
      if (res_lane) {
        need = pick(T_PROTO_IN, T_UPROTO_IN, R, res);
        give = pick(T_PROTO_OUT, T_UPROTO_OUT, R, res);
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          if ((ref_valid >> p) & 1u) total += s_inv[s_ref[p] * RS + res];
          if ((out_valid >> p) & 1u) {
            const int q = (single >= 0 ? single : s_ref[p]) * RS + res;
            total_free += max(s_lim[q] - s_inv[q], 0);
          }
        }
      }
      const bool all_met = __all_sync(FULL, need == 0 || total >= need);
      const bool has_output = __any_sync(FULL, give > 0);
      const bool can_absorb = __any_sync(FULL, give > 0 && total_free >= 1);
      const bool ok = ok0 && p_idx >= 0 && all_met && (!has_output || can_absorb || clipped);

      // shared consume, a group of 8 lanes (one lane a place) per pass:
      // resource PRES[k / 2]'s input pass for even k, its output pass for odd
      if (ok) {  // warp-uniform
        for (int k0 = 0; k0 < 2 * s.n_pres; k0 += 4) {
          const int k = k0 + (lane >> 3);
          const bool on = k < 2 * s.n_pres, out_pass = k & 1;
          const int r = on ? TAB(T_PROTO_RES)[k >> 1] : 0;
          const unsigned valid = on ? (out_pass ? out_valid : ref_valid) : 0u;
          const bool v = (valid >> j) & 1u;
          const int agent = v ? (out_pass && single >= 0 ? single : s_ref[j]) : 0;
          const int delta = !on ? 0 : out_pass ? pick(T_PROTO_OUT, T_UPROTO_OUT, R, r)
                                               : -pick(T_PROTO_IN, T_UPROTO_IN, R, r);
          consume(v, agent, delta, r, s_inv, s_lim, s_acc, RS);
        }
      }
      if (lane == w) {
        my_ok = ok;
        my_cd = cooldown;
      }
      __syncwarp();  // the slot arrays are read: the next station may write them
    }
    __syncwarp();
    apply(any_winner, true);
    // claimed stations: each winner writes its own, after the pass-through copy
    if (my_ok) {
      const size_t es = eNA + st;
      const bool was_clipped = __ldg(in.asm_clipped + es) != 0;
      out.asm_cd_dur[es] = my_cd;
      out.asm_cd_end[es] = step + my_cd;
      if (!was_clipped) out.asm_uses[es] = __ldg(in.asm_uses + es) + 1;
      out.asm_clipped[es] = 0;
      if (was_clipped) out.asm_uproto[es] = -1;
    }
    success = success || my_ok;
  }

  // ---------- chest phase: each winner on its own lane ----------
  if (CHEST) {
    const int NC = s.NC;
    const bool bump = movers && !interacted && skind == s.kind_chest;
    const int ch = clampi(sidx, 0, NC - 1);
    const bool is_winner = lowest_rank(bump, rank, A, __match_any_sync(FULL, ch));
    bool moved = false;
    if (is_winner) {
      const size_t ec = (size_t)e * NC + ch;
      const int t = __ldg(in.chest_type + ec);
      if (__ldg(in.chest_valid + ec) != 0 && t >= 0 && t < s.NT &&
          TAB(T_CHEST_VIBE_HAS)[t * V + vibe_c]) {
        const int* D = TAB(T_CHEST_VIBE_DELTA) + (t * V + vibe_c) * R;
        const int* CL = TAB(T_CHEST_LIMS) + t * R;
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r >= R) break;
          const int d = D[r];
          const int a_inv = s_inv[arow + r];
          const int c_inv = __ldg(in.chest_inv + ec * R + r);
          // deposits: the agent gives what it offers, the chest keeps what
          // fits; withdrawals: the chest gives, the agent keeps what fits
          const int give_dep = d > 0 ? min(a_inv, d) : 0;
          const int got_dep = min(give_dep, max(CL[r] - c_inv, 0));
          const int give_w = d < 0 ? min(c_inv, -d) : 0;
          const int got_w = min(give_w, max(s_lim[arow + r] - a_inv, 0));
          s_acc[arow + r] = got_w - give_dep;  // the winner's own row
          out.chest_inv[ec * R + r] = clampi(c_inv + got_dep - give_w, 0, 65535);
          moved = moved || got_dep > 0 || got_w > 0;
        }
      }
    }
    const bool any = __any_sync(FULL, is_winner);
    __syncwarp();
    apply(any, true);
    success = success || moved;
  }

  // ---------- action resource consumption ----------
  if (s.any_consumed) {
    if (live && success) {
      const int* CONS = TAB(T_ACTION_CONSUMED) + act * R;
#pragma unroll
      for (int r = 0; r < kMaxR; ++r) {
        if (r >= R) break;
        s_acc[arow + r] = -CONS[r];
      }
    }
    const bool any = __any_sync(FULL, live && success);
    __syncwarp();
    apply(any, true);
  }

  // ---------- outputs ----------
  if (live) {
    out.r[ea] = cur_r;
    out.c[ea] = cur_c;
    out.vibe[ea] = vibe;
    out.frozen[ea] = frozen;
    out.success[ea] = success ? 1 : 0;
    out.executed[ea] = success ? act : 0;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      out.inv[eAR + r] = s_inv[arow + r];
      if (track) {
        out.gained[eAR + r] = __ldg(in.gained + eAR + r) + s_gain[arow + r];
        out.lost[eAR + r] = __ldg(in.lost + eAR + r) + s_lost[arow + r];
      }
    }
  }
  __syncwarp();  // the warp's arrays are free for its next env
#undef TAB
}

// At most 64 registers a thread: four blocks of kThreads an SM, 32 resident
// warps, hold the 31 envs an SM takes at E=4096 in one wave.
template <bool ATTACK, bool TRANSFER, bool SWAP, bool ASM, bool CHEST>
__global__ void __launch_bounds__(kThreads, 4)
sim_fused_kernel(In in, Out out, Static s, const int32_t* __restrict__ tab, int n_tab, int E) {
  extern __shared__ __align__(16) int smem[];
  const int A = s.A, R = s.R, RS = row_stride(R);
  const int warps = blockDim.x >> 5;
  int* s_tab = smem;
  int* s_lim = s_tab + round4(n_tab);
  // the table pack and the padded limits, once per block (the pack is
  // 16-byte aligned: the wrapper checks)
  const int n4 = n_tab >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<int4*>(s_tab)[i] = __ldg(reinterpret_cast<const int4*>(tab) + i);
  for (int i = 4 * n4 + threadIdx.x; i < n_tab; i += blockDim.x) s_tab[i] = __ldg(tab + i);
  for (int i = threadIdx.x; i < A * R; i += blockDim.x)
    s_lim[(i / R) * RS + i % R] = __ldg(tab + s.off[T_LIMS] + i);
  __syncthreads();  // the only block barrier

  const int warp = threadIdx.x >> 5;
  int* w_base = s_lim + round4(A * RS) + warp * warp_ints(A, R, s.track_gained);
  for (int e = blockIdx.x * warps + warp; e < E; e += gridDim.x * warps)
    env_span<ATTACK, TRANSFER, SWAP, ASM, CHEST>(e, in, out, s, s_tab, s_lim, w_base);
}

using Kernel = void (*)(In, Out, Static, const int32_t*, int, int);

// The instantiation of each section set: index has_attack | has_transfer << 1
// | has_swap << 2 | has_asm << 3 without chests; with chests (and so with
// assemblers) 16 + (has_attack | has_transfer << 1 | has_swap << 2).
#define K(m) sim_fused_kernel<((m)&1) != 0, ((m)&2) != 0, ((m)&4) != 0, ((m)&8) != 0, false>
#define KC(m) sim_fused_kernel<((m)&1) != 0, ((m)&2) != 0, ((m)&4) != 0, true, true>
const Kernel KERNELS[24] = {K(0),  K(1),  K(2),  K(3),  K(4),  K(5),  K(6),  K(7),
                            K(8),  K(9),  K(10), K(11), K(12), K(13), K(14), K(15),
                            KC(0), KC(1), KC(2), KC(3), KC(4), KC(5), KC(6), KC(7)};
#undef K
#undef KC

Kernel kernel_of(const Static* st) {
  const int m = (st->has_attack != 0) | (st->has_transfer != 0) << 1 | (st->has_swap != 0) << 2;
  return st->has_chest ? KERNELS[16 + m] : KERNELS[m | (st->has_asm != 0) << 3];
}

bool fits(const Static* st, int warps) {
  return st->A >= 1 && st->A <= kMaxA && st->R >= 1 && st->R <= kMaxR && st->NP <= kMaxNP &&
         st->n_pres <= kMaxR && warps >= 1 && warps <= kMaxWarps &&
         (!st->has_chest || (st->has_asm && st->NC >= 1));
}

}  // namespace

// The launch shape of a config: shared memory a block, blocks an SM holds,
// SMs (needs the card). Returns a CUDA error (0 = fine).
extern "C" int sim_fused_shape(const void* statics, int n_tab, int warps, int* smem, int* per_sm,
                               int* sms) {
  const Static* st = (const Static*)statics;
  if (!fits(st, warps)) return (int)cudaErrorInvalidValue;
  *smem = 4 * block_ints(n_tab, st->A, st->R, st->track_gained, warps);
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  const Kernel k = kernel_of(st);
  if (*smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, 32 * warps, *smem);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Launches the span on `stream`: `ins` and `outs` are the device pointers in
// the order of In and Out, `statics` the config's statics, `tab` the table
// pack of `n_tab` ints, `warps` the envs (warps) a block holds. The grid is
// min(ceil(E / warps), SMs x blocks an SM holds). Returns cudaGetLastError()
// (0 = launched).
extern "C" int sim_fused_launch(const void* const* ins, void* const* outs, const void* statics,
                                const void* tab, int n_tab, int E, int warps, void* stream) {
  const Static* st = (const Static*)statics;
  static_assert(sizeof(In) == N_IN * sizeof(void*), "In is a list of pointers");
  static_assert(sizeof(Out) == N_OUT * sizeof(void*), "Out is a list of pointers");
  In in;
  Out out;
  memcpy(&in, ins, sizeof(In));
  memcpy(&out, outs, sizeof(Out));
  int smem, per_sm, sms;
  const int err = sim_fused_shape(statics, n_tab, warps, &smem, &per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long need = ((long long)E + warps - 1) / warps;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(need < most ? need : most);
  if (grid == 0) return 0;
  kernel_of(st)<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(in, out, *st,
                                                                 (const int32_t*)tab, n_tab, E);
  return (int)cudaGetLastError();
}
