// Requirements-intersection kernel: the host scheduler's hottest check.
//
// Reference semantics: pkg/scheduling/requirement.go:220-254 HasIntersection
// and requirements.go:252-286 Intersects — mirrored exactly from the Python
// algebra in karpenter_tpu_torch/scheduling/requirements.py (a Requirement is
// a value-id set + complement flag + inclusive integer bounds; two negative
// requirements on a shared key never conflict).
//
// The FFD host path calls Requirements.intersects per (pod, instance type)
// inside filter_instance_types (nodeclaim.go:541-640) — tens of thousands of
// calls per solve. This kernel holds the interned instance-type requirement
// table once per solve and answers "which rows intersect this query" in one
// C call. It runs on the host: each query is one pod's requirements against
// a few hundred rows, issued from inside the FFD loop, where a device launch
// and its synchronisation would cost more than the call. Built with g++ at
// first use (see native/__init__.py); the Python algebra is the parity
// oracle and answers tables below NATIVE_MIN_TABLE_ROWS.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t NO_BOUND = INT64_MIN;

struct Value {
    int32_t id;
    int64_t num;      // integer value when has_num
    uint8_t has_num;  // value parses as an integer (for bounds checks)
};

struct Req {
    int32_t key;
    uint8_t complement;
    int64_t gte;  // NO_BOUND = absent
    int64_t lte;
    std::vector<Value> values;  // sorted by id
};

struct Table {
    std::vector<std::vector<Req>> rows;  // each row sorted by key
};

bool contains(const std::vector<Value>& vs, int32_t id) {
    size_t lo = 0, hi = vs.size();
    while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (vs[mid].id < id)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo < vs.size() && vs[lo].id == id;
}

bool within(const Value& v, int64_t gte, int64_t lte) {
    if (gte == NO_BOUND && lte == NO_BOUND) return true;
    if (!v.has_num) return false;
    if (gte != NO_BOUND && v.num < gte) return false;
    if (lte != NO_BOUND && v.num > lte) return false;
    return true;
}

// requirement.go:220-254 / requirements.py has_intersection
bool has_intersection(const Req& a, const Req& b) {
    int64_t gte = a.gte;
    if (b.gte != NO_BOUND && (gte == NO_BOUND || b.gte > gte)) gte = b.gte;
    int64_t lte = a.lte;
    if (b.lte != NO_BOUND && (lte == NO_BOUND || b.lte < lte)) lte = b.lte;
    if (gte != NO_BOUND && lte != NO_BOUND && gte > lte) return false;
    if (a.complement && b.complement) return true;
    if (a.complement && !b.complement) {
        for (const auto& v : b.values)
            if (!contains(a.values, v.id) && within(v, gte, lte)) return true;
        return false;
    }
    if (!a.complement && b.complement) {
        for (const auto& v : a.values)
            if (!contains(b.values, v.id) && within(v, gte, lte)) return true;
        return false;
    }
    for (const auto& v : a.values)
        if (contains(b.values, v.id) && within(v, gte, lte)) return true;
    return false;
}

// operator() in (NotIn, DoesNotExist) — requirements.py:164-167
bool is_negative(const Req& r) {
    return r.complement ? !r.values.empty() : r.values.empty();
}

}  // namespace

extern "C" {

void* rk_new() { return new Table(); }

void rk_free(void* h) { delete static_cast<Table*>(h); }

int32_t rk_add_row(void* h) {
    auto* t = static_cast<Table*>(h);
    t->rows.emplace_back();
    return static_cast<int32_t>(t->rows.size()) - 1;
}

// Append one requirement to a row. Rows must receive keys in ascending order
// (the Python side sorts). value_ids sorted ascending; nums/has_num parallel.
void rk_row_add_req(void* h, int32_t row, int32_t key, uint8_t complement, int64_t gte, int64_t lte,
                    const int32_t* value_ids, const int64_t* nums, const uint8_t* has_num, int32_t n) {
    auto* t = static_cast<Table*>(h);
    Req r;
    r.key = key;
    r.complement = complement;
    r.gte = gte;
    r.lte = lte;
    r.values.reserve(n);
    for (int32_t i = 0; i < n; i++) r.values.push_back(Value{value_ids[i], nums[i], has_num[i]});
    t->rows[row].push_back(std::move(r));
}

// Query: flattened requirement array (sorted by key) with a shared value pool.
// out[row] = 1 iff every shared key has a non-empty intersection (with the
// two-negatives exception) — requirements.go Intersects == nil.
void rk_filter(void* h, const int32_t* q_keys, const uint8_t* q_comp, const int64_t* q_gte, const int64_t* q_lte,
               const int32_t* q_val_off, const int32_t* q_val_len, int32_t nq, const int32_t* pool_ids,
               const int64_t* pool_nums, const uint8_t* pool_has_num, uint8_t* out) {
    auto* t = static_cast<Table*>(h);
    std::vector<Req> query(nq);
    for (int32_t i = 0; i < nq; i++) {
        Req& r = query[i];
        r.key = q_keys[i];
        r.complement = q_comp[i];
        r.gte = q_gte[i];
        r.lte = q_lte[i];
        int32_t off = q_val_off[i], len = q_val_len[i];
        r.values.reserve(len);
        for (int32_t j = 0; j < len; j++)
            r.values.push_back(Value{pool_ids[off + j], pool_nums[off + j], pool_has_num[off + j]});
    }
    for (size_t row = 0; row < t->rows.size(); row++) {
        const auto& reqs = t->rows[row];
        bool ok = true;
        size_t i = 0, j = 0;  // merge-join on sorted keys
        while (i < reqs.size() && j < query.size()) {
            if (reqs[i].key < query[j].key) {
                i++;
            } else if (reqs[i].key > query[j].key) {
                j++;
            } else {
                if (!has_intersection(reqs[i], query[j]) &&
                    !(is_negative(reqs[i]) && is_negative(query[j]))) {
                    ok = false;
                    break;
                }
                i++;
                j++;
            }
        }
        out[row] = ok ? 1 : 0;
    }
}

}  // extern "C"
