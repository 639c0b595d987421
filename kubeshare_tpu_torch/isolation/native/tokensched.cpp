// Native token-scheduler core: the port's copy of the JAX package's
// kubeshare_tpu/isolation/native/tokensched.cpp (host C++, not a kernel).
//
// One device is time-sliced between clients by handing out an exclusive
// *token*: a grant carries a quota (ms of device time); the holder runs
// programs until the quota is spent, reports the time it used, and asks
// again.
//
// Scheduling:
//   * stride scheduling — each client carries a virtual time `vtime` that
//     advances by used_ms / request on every release, and the runnable
//     client with the smallest vtime wins (ties: the smaller name), so
//     long-run shares of device time follow the requests;
//   * sliding-window limit cap — per-client usage records over the
//     trailing `window_ms`; a client whose window usage would pass
//     limit * window is ineligible until enough usage expires;
//   * quota — min(base_quota, remaining window allowance), floored at
//     min_quota for eligibility.
//
// Pure computation: no threads, no sockets, no clocks. The caller (the
// Python facade in ../tokensched.py) supplies `now_ms` and does the
// waiting. A plain C interface for ctypes. The JAX copy's
// ts_set_effective (elastic burst credit) has no caller in the port and is
// left out.

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <deque>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct UsageRecord {
  double start_ms;
  double end_ms;
};

struct Client {
  std::string name;
  double request;  // guaranteed fraction of the window
  double limit;    // hard cap fraction of the window
  double vtime = 0.0;
  bool waiting = false;
  std::deque<UsageRecord> usage;  // trailing-window bursts, oldest first

  // Overlap of recorded usage with [now - window, now].
  double window_usage(double now_ms, double window_ms) {
    const double lo = now_ms - window_ms;
    while (!usage.empty() && usage.front().end_ms <= lo) usage.pop_front();
    double total = 0.0;
    for (const auto& r : usage) {
      total += r.end_ms - std::max(r.start_ms, lo);
    }
    return total;
  }

  // Earliest time at which window usage drops to `target_ms` or below,
  // assuming no further bursts. With no new bursts usage is monotonically
  // non-increasing as the window slides, so binary search on time.
  double eligible_at(double now_ms, double window_ms, double target_ms) {
    if (window_usage(now_ms, window_ms) <= target_ms) return now_ms;
    double lo = now_ms, hi = now_ms + window_ms;
    for (int i = 0; i < 48; ++i) {
      const double mid = 0.5 * (lo + hi);
      const double wlo = mid - window_ms;
      double total = 0.0;
      for (const auto& q : usage) {
        if (q.end_ms > wlo) total += q.end_ms - std::max(q.start_ms, wlo);
      }
      if (total <= target_ms) {
        hi = mid;
      } else {
        lo = mid;
      }
    }
    return hi;
  }
};

struct Scheduler {
  double window_ms;
  double base_quota_ms;
  double min_quota_ms;
  std::unordered_map<std::string, Client> clients;
  std::string holder;  // client currently holding the token ("" = free)
  double holder_quota_ms = 0.0;
  double holder_since_ms = 0.0;
};

Client* find(Scheduler* s, const char* name) {
  auto it = s->clients.find(name);
  return it == s->clients.end() ? nullptr : &it->second;
}

}  // namespace

extern "C" {

void* ts_create(double window_ms, double base_quota_ms, double min_quota_ms) {
  auto* s = new Scheduler();
  s->window_ms = window_ms;
  s->base_quota_ms = base_quota_ms;
  s->min_quota_ms = min_quota_ms;
  return s;
}

void ts_destroy(void* h) { delete static_cast<Scheduler*>(h); }

// Register a client. Its vtime starts at the minimum vtime of existing
// clients so it competes fairly without a catch-up monopoly.
int ts_add_client(void* h, const char* name, double request, double limit) {
  auto* s = static_cast<Scheduler*>(h);
  if (request <= 0.0 || limit <= 0.0 || limit > 1.0 || request > limit) return -1;
  if (s->clients.count(name)) return -2;
  double vmin = 0.0;
  bool first = true;
  for (const auto& [k, c] : s->clients) {
    if (first || c.vtime < vmin) vmin = c.vtime;
    first = false;
  }
  Client c;
  c.name = name;
  c.request = request;
  c.limit = limit;
  c.vtime = first ? 0.0 : vmin;
  s->clients.emplace(name, std::move(c));
  return 0;
}

int ts_remove_client(void* h, const char* name) {
  auto* s = static_cast<Scheduler*>(h);
  if (!s->clients.count(name)) return -1;
  if (s->holder == name) {
    s->holder.clear();
    s->holder_quota_ms = 0.0;
  }
  s->clients.erase(name);
  return 0;
}

// Mark a client as wanting the token.
int ts_request_token(void* h, const char* name) {
  auto* s = static_cast<Scheduler*>(h);
  Client* c = find(s, name);
  if (!c) return -1;
  c->waiting = true;
  return 0;
}

// Withdraw a pending request (e.g. the waiter timed out).
int ts_cancel_request(void* h, const char* name) {
  auto* s = static_cast<Scheduler*>(h);
  Client* c = find(s, name);
  if (!c) return -1;
  c->waiting = false;
  return 0;
}

// Try to hand the token to the best runnable waiter.
// Returns 1 and fills (name_out, quota_ms_out) on a grant; returns 0 when no
// grant is possible, with *next_wake_ms_out = earliest time a grant might
// become possible (infinity when the token is held or nobody waits).
int ts_poll(void* h, double now_ms, char* name_out, int name_cap,
            double* quota_ms_out, double* next_wake_ms_out) {
  auto* s = static_cast<Scheduler*>(h);
  const double inf = std::numeric_limits<double>::infinity();
  *next_wake_ms_out = inf;
  if (!s->holder.empty()) return 0;  // exclusive token held

  Client* best = nullptr;
  double best_remaining = 0.0;
  for (auto& [k, c] : s->clients) {
    if (!c.waiting) continue;
    const double cap_ms = c.limit * s->window_ms;
    const double used = c.window_usage(now_ms, s->window_ms);
    const double remaining = cap_ms - used;
    if (remaining < s->min_quota_ms) {
      // At limit: compute when enough usage expires to regain min_quota.
      const double t = c.eligible_at(now_ms, s->window_ms, cap_ms - s->min_quota_ms);
      *next_wake_ms_out = std::min(*next_wake_ms_out, t);
      continue;
    }
    // Lexicographic name tie-break on equal vtime: without it the winner
    // falls to unordered_map iteration order, which drifts from the
    // Python core (dict insertion order) on fresh equal-vtime waiters.
    if (best == nullptr || c.vtime < best->vtime ||
        (c.vtime == best->vtime && c.name < best->name)) {
      best = &c;
      best_remaining = remaining;
    }
  }
  if (best == nullptr) return 0;

  const double quota =
      std::max(s->min_quota_ms, std::min(s->base_quota_ms, best_remaining));
  best->waiting = false;
  s->holder = best->name;
  s->holder_quota_ms = quota;
  s->holder_since_ms = now_ms;
  std::snprintf(name_out, name_cap, "%s", best->name.c_str());
  *quota_ms_out = quota;
  *next_wake_ms_out = inf;
  return 1;
}

// Token holder reports actual device time consumed and releases the token.
int ts_release_token(void* h, const char* name, double used_ms, double now_ms) {
  auto* s = static_cast<Scheduler*>(h);
  Client* c = find(s, name);
  if (!c || s->holder != name) return -1;
  if (used_ms > 0.0) {
    c->usage.push_back({now_ms - used_ms, now_ms});
    c->vtime += used_ms / c->request;
  }
  s->holder.clear();
  s->holder_quota_ms = 0.0;
  return 0;
}

double ts_window_usage(void* h, const char* name, double now_ms) {
  auto* s = static_cast<Scheduler*>(h);
  Client* c = find(s, name);
  if (!c) return -1.0;
  return c->window_usage(now_ms, s->window_ms);
}

int ts_client_count(void* h) {
  return static_cast<int>(static_cast<Scheduler*>(h)->clients.size());
}

// Expose holder for introspection: returns 1 if held (name copied), else 0.
int ts_holder(void* h, char* name_out, int name_cap) {
  auto* s = static_cast<Scheduler*>(h);
  if (s->holder.empty()) return 0;
  std::snprintf(name_out, name_cap, "%s", s->holder.c_str());
  return 1;
}

}  // extern "C"
