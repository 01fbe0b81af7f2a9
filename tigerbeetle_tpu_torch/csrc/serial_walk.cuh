// The exact, event-at-a-time create_transfers commit as one block: a walker
// warp commits the events in order from a shared-memory ring whose entries
// prefetch warps resolved ahead of it, with warp-wide probes.
//
// The walk is the serial tier's, on one table (K4, serial_transfers.cu; the
// JAX `lax.scan` of models/ledger.py `_serial_transfers_core`) and on the
// sharded ledger (K11ts, mesh_serial_transfers.cu; parallel/mesh.py
// `_commit_transfers_serial`): every event validates against the tables as
// the events before it left them, with an undo log for linked-chain
// rollback. One thread doing it walks a chain of about twelve dependent
// device-memory trips an event. Here:
//
// 1. One trip per window. A warp loads a lookup's 64 probe positions at
//    once (positions j and j + 32 in lane j) and decides with ballots what
//    `table_lookup` and `table_probe_free` (hash.cuh) decide: the first hit
//    before the first empty slot; else the first free (empty or tombstone)
//    slot, resolved only if an empty slot ended the chain; an unresolved
//    lane gets the first free slot, else the last probe.
// 2. The lookups of one event together. A prefetch warp issues the debit,
//    credit, id and pending windows of an event in one round (the id's
//    window also gives the free-slot probe), then their four rows and the
//    pending's fulfill word, then the pending's two accounts' windows and
//    rows: four trips after the batch row, in place of twelve.
// 3. Lookahead. WALK_DEPTH prefetch warps fill ring entries for the events
//    after i (entry j % WALK_DEPTH is one warp's) against the tables as they stand, while the
//    walker (warp 0) commits event i. A prefetch warp also runs the
//    validation ladder on its entry and builds the rows the event would
//    write, so the walker's own work on an entry nothing changed is the
//    chain logic and the stores. The walker keeps a log of its writes in
//    shared memory: an account row it rewrites (with the new image), an
//    insert, a pending's fulfill word, a rollback. (An insert's own fulfill
//    word needs no record: an entry that found its row there is redone.) An
//    entry records the log's head when its prefetch began, and before the
//    walker uses it, it checks the records since then: an account row is
//    replaced by its newest image (a hot account's balance chain stays on
//    chip); an insert into the id's or the pending's window at or before
//    the position the answer depends on (the probe position is
//    (t - base) * step^-1 mod 2^k), or a rollback (its tombstones free
//    earlier positions), or a log that wrapped, makes the walker resolve the
//    entry again itself; a fulfill write is forwarded; an entry the check
//    changed is validated again by the walker. Accounts are never inserted
//    here, so an account lookup's slot never changes; a found transfer row
//    is never rewritten but by a rollback. So an entry that passes the
//    check is what a lookup at this point of the walk would give, whichever
//    of the walker's writes its loads saw (the hazard requests of
//    testing/hazards.py aim at each rule; chip_smoke.py holds the kernel
//    against its plain version on them).
//
// Memory order: the walker publishes the log head after its stores
// (__syncwarp, then a release store); a prefetch warp reads the head with
// an acquire load, then loads the tables; entries pass between the warps
// the same way; all of them run on one SM, whose L1 the block shares. The
// block has 16 warps; the prefetch warps are those not on the walker's
// scheduler (warp % 4 != 0), so the walker's issue slots are its own.
//
// The walk is a template over the lookup policy P, which gives the owner
// shard of a key and the first row of a shard's table (the sharded ledger:
// the key's owner of n_shards; a single table: shard 0 at row 0), the
// shard count for the entry gate and the per-shard insert counts, each
// event's timestamp (read once, by the event's prefetch), what commit_ts
// becomes when an event applies, and what a lookup that finds nothing
// gives:
//   int n_shards; int owner(Key4); int64_t base(int shard, int log2);
//   ull ts(int i, int n); ull commit(ull commit_ts, ull ts);
//   static constexpr bool zero_missing.
// With zero_missing (the sharded JAX scan: a psum of owner-masked rows) a
// missing row and its fulfill word read as zero, so a missing pending's
// accounts are probed with key 0. Without it (the single-table JAX scan)
// they are the row and the word at the slot the lookup returned: the first
// free slot (a tombstone may hold a dead transfer's bytes) or the last probe
// (another key's row), whose debit and credit keys are then probed. Such an
// image comes from a transfer slot at or before the lookup's `stop` (the
// first free position is never after the first empty one), so an insert
// there or a rollback already makes the walker resolve the entry again; an
// account slot is watched, found or not, and its newest image forwarded.
// Codes never read a missing row (the ladders test `found` first), but the
// probes of its keys decide FAULT_SERIAL, and the walk's stores go to the
// slots the plain version's do.
#pragma once
#include <cuda_runtime.h>

#include "owner.cuh"
#include "validate.cuh"
#include "warp_window.cuh"

#define WALK_THREADS 512
// prefetch warps (of the 12 off the walker's scheduler) and ring entries:
// on an H100, 8 beat 4 and 12 (PERF.md)
#define WALK_DEPTH 8
#define WALK_LOG 128       // write-log records kept (at most four an event, or a rollback)

// One lookup's answer, and what the log check needs to place a slot in it.
struct WalkLook {
  int64_t slot;  // global row: the hit, else the first free slot, else the last probe
  int64_t sb;    // first row of the probed shard's table
  uint32_t base, inv;  // the first probe position; the inverse of the odd step mod 2^32
  int32_t stop;        // the last window position the answer depends on
  int32_t found, resolved;
};

enum { LK_DR, LK_CR, LK_ID, LK_P, LK_PDR, LK_PCR, LK_N };

enum { OUT_XFER, OUT_DR, OUT_CR, OUT_N };

#define PLAN_LINKED 1u    // the event is linked
#define PLAN_TS_SET 2u    // its timestamp field is not zero
#define PLAN_RESOLVED 4u  // all six lookups resolved
#define PLAN_FREE 8u      // its id's window has a free slot

// What the walker reads of an entry, in one place (walk_speculate).
struct WalkPlan {
  int64_t watch[4];  // the debit, credit, pending debit and pending credit rows, -1 if not found
  int64_t p_slot;    // the pending's row, -1 if not found
  int64_t t_slot;    // the insert target on the id's owner
  uint32_t r_body;   // the code below the chain's rungs
  int32_t kind;      // 1 posted, 2 pending, 3 post, 4 void
  int32_t owner;     // the id's owner shard
  uint32_t bits;     // PLAN_*
};

struct __align__(16) WalkEntry {
  uint32_t row[ROW_WORDS];           // the event
  uint32_t img[LK_N][ROW_WORDS];     // each lookup's row, zero where not found
  // what the event does if it applies (walk_speculate): the stored transfer
  // row, and the debit and credit rows after it
  uint32_t out[OUT_N][ROW_WORDS];
  u128 amt, p_amt;
  ull ts;                            // the event's timestamp
  WalkLook lk[LK_N];
  int64_t fr_slot;                   // the insert target on the id's owner
  int32_t fr_stop, fr_resolved;
  uint32_t p_ful;                    // the pending's fulfill word
  uint32_t seq;                      // the log head when the prefetch began
  WalkPlan plan;
};

enum { REC_ACCT = 1, REC_XINS, REC_FUL, REC_ROLLBACK };

struct WalkRec {
  int64_t slot;
  uint32_t kind, val;
};

struct __align__(16) WalkShared {
  WalkEntry ring[WALK_DEPTH];
  uint32_t img[WALK_LOG][ROW_WORDS];  // the image of each REC_ACCT record
  WalkRec rec[WALK_LOG];
  volatile int ready[WALK_DEPTH];  // the event an entry holds
  volatile int consumed;               // events the walker has committed
  volatile int head;                   // the published log head
  int n;
  uint32_t fault0, probe_bad, ok_n;
  ull cts;
  ull applied[MESH_SHARDS_MAX];
};

// Acquire and release accesses to the ring's flags in shared memory, at
// block scope: they order the memory accesses around them (table rows in
// device memory included) for the other warps of the block.
__device__ __forceinline__ int ld_acquire(const volatile int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared((const void*)p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(volatile int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared((const void*)p)),
               "r"(v)
               : "memory");
}

struct WalkTables {
  uint32_t* acct;
  int a_log2;
  uint32_t* xfer;
  int t_log2;
  uint32_t* fulfill;
};

struct WalkUndo {
  int32_t* kind;  // 0 not applied, 1 posted, 2 pending, 3 post, 4 void
  int64_t* dr_slot;  // global account rows, -1 where none was found
  int64_t* cr_slot;
  int64_t* t_slot;  // the insert's global row
  int64_t* p_slot;  // the pending's global row, -1 if not found
  u128* amt;
  u128* p_amt;
};

static WalkUndo walk_carve_undo(char* scratch, int B, size_t* size) {
  Carver c{scratch, 0};
  WalkUndo u;
  u.kind = c.take<int32_t>(B);
  u.dr_slot = c.take<int64_t>(B);
  u.cr_slot = c.take<int64_t>(B);
  u.t_slot = c.take<int64_t>(B);
  u.p_slot = c.take<int64_t>(B);
  u.amt = c.take<u128>(B);
  u.p_amt = c.take<u128>(B);
  *size = c.off + 256;
  return u;
}

// s * x = 1 mod 2^32 for odd s (Newton's iteration doubles the correct
// low bits, from 3: s * s = 1 mod 8).
__device__ __forceinline__ uint32_t inv_odd(uint32_t s) {
  uint32_t x = s;
#pragma unroll
  for (int k = 0; k < 4; k++) x *= 2u - s * x;
  return x;
}

// table_lookup of `key` from the window `w` (warp-uniform); with `fr`, also
// table_probe_free's answer: the first free position, or the last probe.
__device__ __forceinline__ WalkLook win_resolve(const WalkWin& w, const Key4& key,
                                                WalkEntry* fr = nullptr) {
  const WinIdx x = win_index(w, key);
  const int h = x.h, e = x.e, f = x.f;
  int fl = min(f, WINDOW_SCALAR - 1);
  WalkLook l;
  l.sb = w.sb;
  l.base = w.pr.base;
  l.inv = inv_odd(w.pr.step);
  l.found = h < e;
  l.resolved = l.found || e < WINDOW_SCALAR;
  l.slot = w.sb + w.pr.at(l.found ? h : fl);
  l.stop = l.found ? h : min(e, WINDOW_SCALAR - 1);
  if (fr != nullptr && (threadIdx.x & 31) == 0) {
    fr->fr_slot = w.sb + w.pr.at(fl);
    fr->fr_stop = fl;
    fr->fr_resolved = f < WINDOW_SCALAR;
  }
  return l;
}

// Global row t lies in l's probe window at a position <= stop.
__device__ __forceinline__ bool win_covers(const WalkLook& l, int64_t t, int stop,
                                           uint32_t mask) {
  int64_t tl = t - l.sb;
  if (tl < 0 || tl > (int64_t)mask) return false;
  uint32_t j = (((uint32_t)tl - l.base) * l.inv) & mask;
  return (int)j <= stop;
}

__device__ __forceinline__ Key4 key_words(const uint32_t* w) {
  return Key4{{w[0], w[1], w[2], w[3]}};
}

// One warp resolves event `brow` into E against the tables as they stand.
template <class P>
__device__ void walk_fill(WalkEntry* E, const P& pol, const WalkTables& tb,
                          const uint32_t* brow, uint32_t seq, int lane) {
  E->row[lane] = brow[lane];
  __syncwarp();
  Key4 kdr = key_words(E->row + 4), kcr = key_words(E->row + 8);
  Key4 kid = key_words(E->row + 0), kp = key_words(E->row + 16);
  WalkWin wdr = win_load(tb.acct, tb.a_log2, pol.base(pol.owner(kdr), tb.a_log2), kdr, lane);
  WalkWin wcr = win_load(tb.acct, tb.a_log2, pol.base(pol.owner(kcr), tb.a_log2), kcr, lane);
  WalkWin wid = win_load(tb.xfer, tb.t_log2, pol.base(pol.owner(kid), tb.t_log2), kid, lane);
  WalkWin wp = win_load(tb.xfer, tb.t_log2, pol.base(pol.owner(kp), tb.t_log2), kp, lane);
  WalkLook ldr = win_resolve(wdr, kdr), lcr = win_resolve(wcr, kcr);
  WalkLook lid = win_resolve(wid, kid, E), lp = win_resolve(wp, kp);
  const bool keep = !P::zero_missing;  // a missing lookup's image: its slot's row
  uint32_t vdr = ldr.found || keep ? tb.acct[(size_t)ldr.slot * ROW_WORDS + lane] : 0u;
  uint32_t vcr = lcr.found || keep ? tb.acct[(size_t)lcr.slot * ROW_WORDS + lane] : 0u;
  uint32_t vex = lid.found || keep ? tb.xfer[(size_t)lid.slot * ROW_WORDS + lane] : 0u;
  uint32_t vp = lp.found || keep ? tb.xfer[(size_t)lp.slot * ROW_WORDS + lane] : 0u;
  uint32_t pful = lp.found || keep ? tb.fulfill[lp.slot] : 0u;
  E->img[LK_DR][lane] = vdr;
  E->img[LK_CR][lane] = vcr;
  E->img[LK_ID][lane] = vex;
  E->img[LK_P][lane] = vp;
  __syncwarp();
  // the pending's accounts, keyed by its image: with zero_missing, key 0
  // when it is missing
  Key4 kpdr = key_words(E->img[LK_P] + 4), kpcr = key_words(E->img[LK_P] + 8);
  WalkWin wpdr = win_load(tb.acct, tb.a_log2, pol.base(pol.owner(kpdr), tb.a_log2), kpdr, lane);
  WalkWin wpcr = win_load(tb.acct, tb.a_log2, pol.base(pol.owner(kpcr), tb.a_log2), kpcr, lane);
  WalkLook lpdr = win_resolve(wpdr, kpdr), lpcr = win_resolve(wpcr, kpcr);
  E->img[LK_PDR][lane] = lpdr.found || keep ? tb.acct[(size_t)lpdr.slot * ROW_WORDS + lane] : 0u;
  E->img[LK_PCR][lane] = lpcr.found || keep ? tb.acct[(size_t)lpcr.slot * ROW_WORDS + lane] : 0u;
  if (lane == 0) {
    E->lk[LK_DR] = ldr;
    E->lk[LK_CR] = lcr;
    E->lk[LK_ID] = lid;
    E->lk[LK_P] = lp;
    E->lk[LK_PDR] = lpdr;
    E->lk[LK_PCR] = lpcr;
    E->p_ful = pful;
    E->seq = seq;
  }
  __syncwarp();
}

// Lane 0 of the warp that holds E: the validation ladder on E's rows, and
// the rows event i writes if it applies (the same steps as the one-thread
// walk of the JAX scan, with no chain rung: the walker puts that first).
template <class P>
__device__ void walk_speculate(WalkEntry* E, const P& pol) {
  const WalkLook* lk = E->lk;
  Row row = load_row(E->row);
  Xfer e = unpack_transfer(row);
  const ull ts = E->ts;
  Xfer ea = e;
  ea.ts = ts;
  uint32_t r = transfer_common(e, 0u);
  Acct dr = unpack_account(load_row(E->img[LK_DR]));
  Acct cr = unpack_account(load_row(E->img[LK_CR]));
  Xfer ex = unpack_transfer(load_row(E->img[LK_ID]));
  Xfer p = unpack_transfer(load_row(E->img[LK_P]));
  bool is_pv = (e.flags & (F_POST | F_VOID)) != 0u;
  u128 amt;
  if (is_pv) {
    r = validate_post_void(r, ea, p, E->p_ful, lk[LK_P].found, ex, lk[LK_ID].found, &amt);
  } else {
    r = validate_simple_transfer(r, ea, dr, cr, lk[LK_DR].found, lk[LK_CR].found, ex,
                                 lk[LK_ID].found, &amt);
  }
  bool is_post = is_pv && (e.flags & F_POST) != 0u;
  bool is_pending = !is_pv && (e.flags & F_PENDING) != 0u;
  WalkPlan pl;
  const int refs[4] = {LK_DR, LK_CR, LK_PDR, LK_PCR};
  bool resolved = true;
  for (int k = 0; k < LK_N; k++) resolved = resolved && lk[k].resolved;
  const bool keep = !P::zero_missing;
  for (int k = 0; k < 4; k++) pl.watch[k] = lk[refs[k]].found || keep ? lk[refs[k]].slot : -1;
  pl.p_slot = lk[LK_P].found || keep ? lk[LK_P].slot : -1;
  pl.t_slot = E->fr_slot;
  pl.r_body = r;
  pl.kind = is_pv ? (is_post ? 3 : 4) : (is_pending ? 2 : 1);
  pl.owner = pol.owner(key_in(row, 0));
  pl.bits = ((e.flags & F_LINKED) ? PLAN_LINKED : 0u) | (e.ts != 0 ? PLAN_TS_SET : 0u) |
            (resolved ? PLAN_RESOLVED : 0u) | (E->fr_resolved ? PLAN_FREE : 0u);
  E->plan = pl;
  E->amt = amt;
  E->p_amt = p.amt;
  if (r != 0u) return;
  store_row(E->out[OUT_XFER], pack_transfer(build_stored_transfer(e, p, is_pv, amt, ts)));
  // balances on the accounts' owners: post/void move the PENDING's
  if (is_pv) {
    dr = unpack_account(load_row(E->img[LK_PDR]));
    cr = unpack_account(load_row(E->img[LK_PCR]));
  }
  if (is_pending) {
    dr.dp += amt;
    cr.cp += amt;
  }
  if (is_pv) {
    dr.dp -= p.amt;
    cr.cp -= p.amt;
  }
  if (is_post || (!is_pv && !is_pending)) {
    dr.dpo += amt;
    cr.cpo += amt;
  }
  store_row(E->out[OUT_DR], pack_account(dr));
  store_row(E->out[OUT_CR], pack_account(cr));
}

// A prefetch warp: the events j = slot, slot + WALK_DEPTH, ... into ring[slot].
template <class P>
__device__ void walk_prefetch(WalkShared& sh, const P& pol, const WalkTables& tb,
                              const uint32_t* batch, int n, int slot, int lane) {
  for (int j = slot; j < n; j += WALK_DEPTH) {
    uint32_t seq = 0;
    if (lane == 0) {
      while (ld_acquire(&sh.consumed) <= j - WALK_DEPTH) __nanosleep(64);
      seq = (uint32_t)ld_acquire(&sh.head);
    }
    __syncwarp();
    seq = __shfl_sync(WALK_FULL, seq, 0);
    WalkEntry* E = &sh.ring[slot];
    if (lane == 0) E->ts = pol.ts(j, n);
    walk_fill(E, pol, tb, batch + (size_t)j * ROW_WORDS, seq, lane);
    if (lane == 0) walk_speculate(E, pol);
    __syncwarp();
    if (lane == 0) st_release(&sh.ready[slot], j);
  }
}

struct WalkChain {
  int start;
  bool broken;
};

// Append a log record: lane 0 writes it, every lane counts it.
__device__ __forceinline__ void walk_record(WalkShared& sh, uint32_t& head, int kind,
                                            int64_t slot, uint32_t val, int lane) {
  if (lane == 0) {
    WalkRec& rc = sh.rec[head % WALK_LOG];
    rc.slot = slot;
    rc.kind = (uint32_t)kind;
    rc.val = val;
  }
  head++;
}

// Event i from its checked entry, by the whole walker warp: every lane
// follows the chain (the same values in every lane), lane 0 makes the
// scalar writes (fulfill, the log records, the undo log, codes, a chain's
// rollback), and lane w copies word w of each row written, in the order of
// the one-thread walk of the JAX scan.
template <class P>
__device__ void walk_event(WalkShared& sh, const WalkEntry* E, const P& pol,
                           const WalkTables& tb, int i, int n, int32_t* results, WalkUndo u,
                           WalkChain& chain, uint32_t& head, int lane) {
  const WalkPlan pl = E->plan;
  bool linked = (pl.bits & PLAN_LINKED) != 0u;
  if (linked && chain.start < 0) chain.start = i;
  bool in_chain = chain.start >= 0;
  uint32_t r = (in_chain && i == n - 1 && linked) ? 2u
               : chain.broken                     ? 1u
               : (pl.bits & PLAN_TS_SET)          ? 3u
                                                  : pl.r_body;
  if (lane == 0) {
    if (!(pl.bits & PLAN_RESOLVED)) sh.probe_bad = 1u;
    u.kind[i] = 0;
  }
  if (r == 0u) {
    const bool is_pv = pl.kind >= 3;
    if (pl.bits & PLAN_FREE) {
      tb.xfer[(size_t)pl.t_slot * ROW_WORDS + lane] = E->out[OUT_XFER][lane];
      if (lane == 0) tb.fulfill[pl.t_slot] = 0u;
      walk_record(sh, head, REC_XINS, pl.t_slot, 0u, lane);
    } else if (lane == 0) {
      sh.probe_bad = 1u;
    }
    if (is_pv && pl.p_slot >= 0) {
      uint32_t v = pl.kind == 3 ? 1u : 2u;
      if (lane == 0) tb.fulfill[pl.p_slot] = v;
      walk_record(sh, head, REC_FUL, pl.p_slot, v, lane);
    }
    // balances on the accounts' owners: post/void move the PENDING's
    const int64_t sides[2] = {is_pv ? pl.watch[2] : pl.watch[0],
                              is_pv ? pl.watch[3] : pl.watch[1]};
    for (int side = 0; side < 2; side++) {
      if (sides[side] < 0) continue;
      uint32_t w = E->out[OUT_DR + side][lane];
      sh.img[head % WALK_LOG][lane] = w;
      tb.acct[(size_t)sides[side] * ROW_WORDS + lane] = w;
      walk_record(sh, head, REC_ACCT, sides[side], 0u, lane);
    }
    if (lane == 0) {
      sh.cts = pol.commit(sh.cts, E->ts);
      u.kind[i] = pl.kind;
      u.dr_slot[i] = sides[0];
      u.cr_slot[i] = sides[1];
      u.t_slot[i] = pl.t_slot;
      u.p_slot[i] = pl.p_slot;
      u.amt[i] = E->amt;
      u.p_amt[i] = E->p_amt;
      sh.applied[pl.owner]++;
    }
  }

  if (r != 0u && in_chain && !chain.broken) {  // roll back [chain.start, i)
    if (lane == 0) {
      Row tomb;
      for (int k = 0; k < ROW_WORDS; k++) tomb.w[k] = TOMB_WORD;
      for (int k = chain.start; k < i; k++) {
        int kd = u.kind[k];
        if (kd == 0) continue;
        int64_t slots[2] = {u.dr_slot[k], u.cr_slot[k]};
        for (int side = 0; side < 2; side++) {
          if (slots[side] < 0) continue;
          uint32_t* w = tb.acct + (size_t)slots[side] * ROW_WORDS;
          Acct f = unpack_account(load_row(w));
          u128& pend = side == 0 ? f.dp : f.cp;
          u128& post = side == 0 ? f.dpo : f.cpo;
          if (kd == 3 || kd == 4) pend += u.p_amt[k];
          if (kd == 2) pend -= u.amt[k];
          if (kd == 1 || kd == 3) post -= u.amt[k];
          store_row(w, pack_account(f));
        }
        store_row(tb.xfer + (size_t)u.t_slot[k] * ROW_WORDS, tomb);
        if ((kd == 3 || kd == 4) && u.p_slot[k] >= 0) tb.fulfill[u.p_slot[k]] = 0u;
      }
    }
    for (int k = chain.start + lane; k < i; k += 32) results[k] = 1;
    walk_record(sh, head, REC_ROLLBACK, -1, 0u, lane);
    chain.broken = true;
  }
  if (lane == 0) results[i] = (int32_t)r;
  if (in_chain && (!linked || r == 2u)) {
    chain.start = -1;
    chain.broken = false;
  }
}

// The walker warp: events 0 .. n-1 in order.
template <class P>
__device__ void walk_commit(WalkShared& sh, const P& pol, const WalkTables& tb,
                            const uint32_t* batch, int n, int32_t* results,
                            WalkUndo u, int lane) {
  const uint32_t t_mask = (1u << tb.t_log2) - 1u;
  const int refs[4] = {LK_DR, LK_CR, LK_PDR, LK_PCR};
  WalkChain chain{-1, false};
  uint32_t head = 0;
  for (int i = 0; i < n; i++) {
    WalkEntry* E = &sh.ring[i % WALK_DEPTH];
    if (lane == 0) {
      while (ld_acquire(&sh.ready[i % WALK_DEPTH]) != i) {
      }
    }
    __syncwarp();
    // the log records since E's prefetch began
    uint32_t s0 = E->seq;
    bool redo = head - s0 > WALK_LOG;
    int best[4] = {-1, -1, -1, -1};
    int best_ful = -1;
    if (!redo && s0 + lane < head) {
      const WalkLook lid = E->lk[LK_ID], lp = E->lk[LK_P];
      const int id_stop = max(lid.stop, E->fr_stop);
      int64_t watch[4];
#pragma unroll
      for (int k = 0; k < 4; k++) watch[k] = E->plan.watch[k];
      const int64_t p_watch = E->plan.p_slot;
      for (uint32_t q = s0 + lane; q < head; q += 32) {
        const WalkRec rc = sh.rec[q % WALK_LOG];
        if (rc.kind == REC_ROLLBACK) {
          redo = true;
        } else if (rc.kind == REC_XINS) {
          if (win_covers(lid, rc.slot, id_stop, t_mask) ||
              win_covers(lp, rc.slot, lp.stop, t_mask))
            redo = true;
        } else if (rc.kind == REC_ACCT) {
#pragma unroll
          for (int k = 0; k < 4; k++) {
            if (watch[k] == rc.slot) best[k] = (int)q;
          }
        } else if (rc.kind == REC_FUL && p_watch == rc.slot) {
          best_ful = (int)q;
        }
      }
    }
    bool changed = __any_sync(WALK_FULL, redo);
    const bool matched = __any_sync(
        WALK_FULL, best[0] >= 0 || best[1] >= 0 || best[2] >= 0 || best[3] >= 0 || best_ful >= 0);
    if (changed) {
      walk_fill(E, pol, tb, batch + (size_t)i * ROW_WORDS, head, lane);
    } else if (matched) {
#pragma unroll
      for (int k = 0; k < 4; k++) {
        int b = __reduce_max_sync(WALK_FULL, best[k]);
        if (b < 0) continue;
        uint32_t v = sh.img[b % WALK_LOG][lane];
        if (__any_sync(WALK_FULL, v != E->img[refs[k]][lane])) {
          changed = true;
          E->img[refs[k]][lane] = v;
        }
      }
      int b = __reduce_max_sync(WALK_FULL, best_ful);
      if (b >= 0 && sh.rec[b % WALK_LOG].val != E->p_ful) {
        changed = true;
        __syncwarp();
        if (lane == 0) E->p_ful = sh.rec[b % WALK_LOG].val;
      }
    }
    __syncwarp();
    if (changed) {
      if (lane == 0) walk_speculate(E, pol);
      __syncwarp();
    }
    walk_event(sh, E, pol, tb, i, n, results, u, chain, head, lane);
    __syncwarp();
    if (lane == 0) {
      st_release(&sh.head, (int)head);
      st_release(&sh.consumed, i + 1);
    }
  }
}

// The whole commit of `batch` (lanes < n) in one block of WALK_THREADS
// threads. Entry gates: the sticky fault, and
// the load guard with all n events charged against every shard (a tripped
// gate makes n = 0). `used` holds pol.n_shards counters.
template <class P>
__global__ void __launch_bounds__(WALK_THREADS, 1)
    serial_walk(WalkTables tb, P pol, ull* commit_ts, ull* count, ull* used,
                uint32_t* fault, const uint32_t* batch, int B, int n, int32_t* results,
                WalkUndo u) {
  __shared__ WalkShared sh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < B; i += blockDim.x) results[i] = 0;
  for (int k = threadIdx.x; k < WALK_DEPTH; k += blockDim.x) sh.ready[k] = -1;
  for (int s = threadIdx.x; s < MESH_SHARDS_MAX; s += blockDim.x) sh.applied[s] = 0ull;
  if (threadIdx.x == 0) {
    uint32_t f0 = *fault;
    for (int s = 0; s < pol.n_shards; s++) {
      if (used[s] + (ull)n > (1ull << tb.t_log2) / 2) f0 |= FAULT_CAPACITY;
    }
    sh.fault0 = f0;
    sh.n = f0 ? 0 : n;
    sh.consumed = 0;
    sh.head = 0u;
    sh.probe_bad = 0u;
    sh.ok_n = 0u;
    sh.cts = *commit_ts;
  }
  __syncthreads();
  const int ne = sh.n;
  const int slot = warp - 1 - (warp >> 2);  // the warps off the walker's scheduler, in order
  if (warp == 0) {
    walk_commit(sh, pol, tb, batch, ne, results, u, lane);
  } else if ((warp & 3) != 0 && slot < WALK_DEPTH) {
    walk_prefetch(sh, pol, tb, batch, ne, slot, lane);
  }
  __syncthreads();
  unsigned ok = 0;
  for (int i = threadIdx.x; i < ne; i += blockDim.x) ok += results[i] == 0;
  ok = __reduce_add_sync(WALK_FULL, ok);
  if (lane == 0 && ok) atomicAdd(&sh.ok_n, ok);
  __syncthreads();
  if (threadIdx.x == 0) {
    *commit_ts = sh.cts;
    *count += sh.ok_n;
    for (int s = 0; s < pol.n_shards; s++) used[s] += sh.applied[s];
    *fault = sh.fault0 | (sh.probe_bad ? FAULT_SERIAL : 0u);
  }
}
