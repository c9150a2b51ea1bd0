// Host-side helpers of chemlab_tpu_torch (C++, no CUDA).
//
// The port's own copy of the reference's native host library: it speeds up
// the host-side data pipeline that feeds the card:
//
//   - fixed-column GROMACS .gro parsing (large configurations)
//   - topology exclusion generation: all pairs within nrexcl bonds
//     (ref behavior: src/chemlab/gromacs_topology.py:298-377)
//
// Exposed as a plain C ABI for ctypes; chemlab_tpu_torch/native.py builds
// it with g++ at first use (into chemlab_tpu_torch/_build/) and wraps it.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <unordered_set>
#include <queue>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// .gro parsing
// ---------------------------------------------------------------------------
// Fixed columns (ref: src/chemlab/files_io.py:161-259):
//   res_idx  [0:5)   res_name [5:10)  atom_name [10:15)  atom_id [15:20)
//   x,y,z    8.3f starting at 20; optional velocities 3 x 8.4f; box on the
//   last line.  Returns 0 on success.

static double parse_field(const char* p, int width) {
    char buf[32];
    int n = width < 31 ? width : 31;
    std::memcpy(buf, p, n);
    buf[n] = '\0';
    return std::atof(buf);
}

static long parse_int_field(const char* p, int width) {
    char buf[32];
    int n = width < 31 ? width : 31;
    std::memcpy(buf, p, n);
    buf[n] = '\0';
    return std::atol(buf);
}

int parse_gro(const char* text, int64_t text_len,
              int64_t* n_atoms_out,
              double* pos,          // (n_atoms, 3) preallocated
              double* vel,          // (n_atoms, 3) preallocated
              int32_t* has_vel_out,
              int64_t* atom_ids,    // (n_atoms,)
              int64_t* res_idx,     // (n_atoms,)
              char* res_names,      // (n_atoms, 8) zero-padded
              char* atom_names,     // (n_atoms, 8)
              double* box)          // (3,)
{
    // split lines
    const char* p = text;
    const char* end = text + text_len;
    auto next_line = [&](const char*& s, const char*& e) -> bool {
        if (p >= end) return false;
        s = p;
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        e = nl ? nl : end;
        p = nl ? nl + 1 : end;
        return true;
    };

    const char *s, *e;
    if (!next_line(s, e)) return 1;                 // title
    if (!next_line(s, e)) return 1;                 // atom count
    long n = std::atol(std::string(s, e - s).c_str());
    if (n <= 0 || n > *n_atoms_out) return 2;       // caller passes capacity
    *n_atoms_out = n;

    int has_vel = -1;
    for (long i = 0; i < n; ++i) {
        if (!next_line(s, e)) return 3;
        long len = e - s;
        if (len < 44) return 4;
        res_idx[i] = parse_int_field(s, 5);
        std::memset(res_names + i * 8, 0, 8);
        std::memset(atom_names + i * 8, 0, 8);
        // trim spaces from the 5-char name fields
        for (int k = 0, w = 0; k < 5; ++k)
            if (s[5 + k] != ' ') res_names[i * 8 + w++] = s[5 + k];
        for (int k = 0, w = 0; k < 5; ++k)
            if (s[10 + k] != ' ') atom_names[i * 8 + w++] = s[10 + k];
        atom_ids[i] = parse_int_field(s + 15, 5);
        pos[i * 3 + 0] = parse_field(s + 20, 8);
        pos[i * 3 + 1] = parse_field(s + 28, 8);
        pos[i * 3 + 2] = parse_field(s + 36, 8);
        if (has_vel < 0) has_vel = (len >= 68) ? 1 : 0;
        if (has_vel == 1 && len >= 68) {
            vel[i * 3 + 0] = parse_field(s + 44, 8);
            vel[i * 3 + 1] = parse_field(s + 52, 8);
            vel[i * 3 + 2] = parse_field(s + 60, 8);
        }
    }
    *has_vel_out = has_vel == 1 ? 1 : 0;
    if (!next_line(s, e)) return 5;                 // box line
    {
        std::string line(s, e - s);
        char* q = const_cast<char*>(line.c_str());
        box[0] = std::strtod(q, &q);
        box[1] = std::strtod(q, &q);
        box[2] = std::strtod(q, &q);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// exclusion generation
// ---------------------------------------------------------------------------
// BFS to nrexcl hops over the bond graph; returns sorted unique (lo, hi)
// 1-based pairs. The caller first asks for the count (out=nullptr), then
// retrieves the pairs.

struct ExclusionResult {
    std::vector<int64_t> pairs;   // encoded lo * 2^32 + hi
};

void* generate_exclusions(const int64_t* bonds, int64_t n_bonds,
                          int32_t nrexcl, int64_t* n_pairs_out)
{
    // adjacency
    std::unordered_set<int64_t> pair_set;
    pair_set.reserve(static_cast<size_t>(n_bonds) * 4);
    int64_t max_id = 0;
    for (int64_t b = 0; b < n_bonds; ++b) {
        max_id = std::max(max_id, std::max(bonds[2 * b], bonds[2 * b + 1]));
    }
    std::vector<std::vector<int32_t>> adj(static_cast<size_t>(max_id) + 1);
    for (int64_t b = 0; b < n_bonds; ++b) {
        int64_t i = bonds[2 * b], j = bonds[2 * b + 1];
        adj[i].push_back(static_cast<int32_t>(j));
        adj[j].push_back(static_cast<int32_t>(i));
        int64_t lo = std::min(i, j), hi = std::max(i, j);
        pair_set.insert((lo << 32) | hi);
    }

    if (nrexcl > 0) {
        std::vector<int32_t> dist(adj.size());
        std::vector<int32_t> touched;
        for (int64_t root = 0; root < static_cast<int64_t>(adj.size()); ++root) {
            if (adj[root].empty()) continue;
            touched.clear();
            std::queue<int32_t> q;
            q.push(static_cast<int32_t>(root));
            dist[root] = 1;  // mark with depth+1, 0 = unvisited
            touched.push_back(static_cast<int32_t>(root));
            while (!q.empty()) {
                int32_t u = q.front(); q.pop();
                int32_t d = dist[u];
                if (d > nrexcl) continue;
                for (int32_t v : adj[u]) {
                    if (!dist[v]) {
                        dist[v] = d + 1;
                        touched.push_back(v);
                        q.push(v);
                        if (v > root) {
                            pair_set.insert((root << 32) | v);
                        } else if (v < root) {
                            pair_set.insert((static_cast<int64_t>(v) << 32) | root);
                        }
                    }
                }
            }
            for (int32_t t : touched) dist[t] = 0;
        }
    }

    auto* res = new ExclusionResult();
    res->pairs.assign(pair_set.begin(), pair_set.end());
    std::sort(res->pairs.begin(), res->pairs.end());
    *n_pairs_out = static_cast<int64_t>(res->pairs.size());
    return res;
}

void fetch_exclusions(void* handle, int64_t* out) {
    auto* res = static_cast<ExclusionResult*>(handle);
    for (size_t k = 0; k < res->pairs.size(); ++k) {
        out[2 * k] = res->pairs[k] >> 32;
        out[2 * k + 1] = res->pairs[k] & 0xffffffff;
    }
    delete res;
}

}  // extern "C"
