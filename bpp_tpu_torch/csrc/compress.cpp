// The PyTorch port's copy of native/compress.cpp (unchanged but for this
// header), so that bpp_tpu_torch builds nothing into native/: the port's
// data/cnative.py compiles it with the host compiler into
// bpp_tpu_torch/_build/ (core/_build.py build_host).
//
// Site-pattern compression, native core (the TPU build's analog of the
// reference's src/compress.c column string sort + JC69 folding).
//
// Exported with a plain C ABI and loaded from Python via ctypes
// (bpp_tpu/data/cnative.py; in the port bpp_tpu_torch/data/cnative.py).
// Semantics are bit-identical to the numpy path in
// bpp_tpu/data/compress.py:
//   * optional JC69 symmetry folding (encode_jc69, compress.c:161):
//     columns whose characters are all single states {A,C,G,T} or gaps
//     are relabeled by order of first appearance (gaps fixed),
//   * unique columns with multiplicities, emitted either in
//     first-appearance order or in lexicographic byte order of the
//     encoded column (the reference's ssort1 order, compress.c:35).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 compress.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// codes: row-major [n_seq][n_sites] ambiguity bitmasks (uint8 for
// nucleotides).  out_patterns: caller-allocated [n_sites][n_seq]
// (pattern-major; only the first *n_patterns rows are written).
// out_weights: caller-allocated [n_sites] int32.  Returns 0 on success.
int bpp_compress_patterns(const uint8_t* codes, int64_t n_seq,
                          int64_t n_sites, int jc69_fold, int sorted_order,
                          uint8_t* out_patterns, int32_t* out_weights,
                          int64_t* n_patterns_out)
{
    if (n_seq <= 0 || n_sites <= 0)
        return 1;

    // column-major working copy W[site][seq]
    std::vector<uint8_t> W((size_t)n_sites * (size_t)n_seq);
    for (int64_t s = 0; s < n_seq; ++s)
        for (int64_t j = 0; j < n_sites; ++j)
            W[(size_t)j * n_seq + s] = codes[(size_t)s * n_sites + j];

    if (jc69_fold)
    {
        for (int64_t j = 0; j < n_sites; ++j)
        {
            uint8_t* col = &W[(size_t)j * n_seq];
            bool ok = true, any = false;
            for (int64_t s = 0; s < n_seq; ++s)
            {
                uint8_t c = col[s];
                if (!(c == 1 || c == 2 || c == 4 || c == 8 || c == 15))
                {
                    ok = false;
                    break;
                }
                if (c != 15) any = true;
            }
            if (!ok || !any)
                continue;
            // relabel by first appearance; unseen states keep their
            // relative order after the seen ones (stable argsort)
            int map[4] = {-1, -1, -1, -1};
            int next = 0;
            for (int64_t s = 0; s < n_seq && next < 4; ++s)
            {
                uint8_t c = col[s];
                if (c == 15) continue;
                int st = (c == 1) ? 0 : (c == 2) ? 1 : (c == 4) ? 2 : 3;
                if (map[st] < 0) map[st] = next++;
            }
            for (int st = 0; st < 4; ++st)
                if (map[st] < 0) map[st] = next++;
            for (int64_t s = 0; s < n_seq; ++s)
            {
                uint8_t c = col[s];
                if (c == 15) continue;
                int st = (c == 1) ? 0 : (c == 2) ? 1 : (c == 4) ? 2 : 3;
                col[s] = (uint8_t)(1u << map[st]);
            }
        }
    }

    // sort site indices by column bytes
    std::vector<int64_t> idx(n_sites);
    for (int64_t j = 0; j < n_sites; ++j) idx[j] = j;
    const uint8_t* base = W.data();
    const size_t k = (size_t)n_seq;
    std::sort(idx.begin(), idx.end(), [base, k](int64_t a, int64_t b) {
        int c = std::memcmp(base + (size_t)a * k, base + (size_t)b * k, k);
        if (c != 0) return c < 0;
        return a < b;
    });

    // group equal adjacent columns; representative = min original index
    struct Group { int64_t first; int64_t sorted_pos; int32_t count; };
    std::vector<Group> groups;
    int64_t j = 0;
    while (j < n_sites)
    {
        int64_t j2 = j + 1;
        int64_t mn = idx[j];
        while (j2 < n_sites &&
               std::memcmp(base + (size_t)idx[j2] * k,
                           base + (size_t)idx[j] * k, k) == 0)
        {
            if (idx[j2] < mn) mn = idx[j2];
            ++j2;
        }
        groups.push_back({mn, j, (int32_t)(j2 - j)});
        j = j2;
    }
    if (!sorted_order)
        std::sort(groups.begin(), groups.end(),
                  [](const Group& a, const Group& b) {
                      return a.first < b.first;
                  });

    for (size_t g = 0; g < groups.size(); ++g)
    {
        std::memcpy(out_patterns + g * k,
                    base + (size_t)groups[g].first * k, k);
        out_weights[g] = groups[g].count;
    }
    *n_patterns_out = (int64_t)groups.size();
    return 0;
}

// uint32 variant (20-bit amino-acid masks)
int bpp_compress_patterns_u32(const uint32_t* codes, int64_t n_seq,
                              int64_t n_sites, int sorted_order,
                              uint32_t* out_patterns, int32_t* out_weights,
                              int64_t* n_patterns_out)
{
    if (n_seq <= 0 || n_sites <= 0)
        return 1;
    std::vector<uint32_t> W((size_t)n_sites * (size_t)n_seq);
    for (int64_t s = 0; s < n_seq; ++s)
        for (int64_t j = 0; j < n_sites; ++j)
            W[(size_t)j * n_seq + s] = codes[(size_t)s * n_sites + j];
    std::vector<int64_t> idx(n_sites);
    for (int64_t j = 0; j < n_sites; ++j) idx[j] = j;
    const uint32_t* base = W.data();
    const size_t k = (size_t)n_seq;
    const size_t kb = k * sizeof(uint32_t);
    std::sort(idx.begin(), idx.end(), [base, kb, k](int64_t a, int64_t b) {
        int c = std::memcmp(base + (size_t)a * k, base + (size_t)b * k, kb);
        if (c != 0) return c < 0;
        return a < b;
    });
    struct Group { int64_t first; int32_t count; };
    std::vector<Group> groups;
    int64_t j = 0;
    while (j < n_sites)
    {
        int64_t j2 = j + 1;
        int64_t mn = idx[j];
        while (j2 < n_sites &&
               std::memcmp(base + (size_t)idx[j2] * k,
                           base + (size_t)idx[j] * k, kb) == 0)
        {
            if (idx[j2] < mn) mn = idx[j2];
            ++j2;
        }
        groups.push_back({mn, (int32_t)(j2 - j)});
        j = j2;
    }
    if (!sorted_order)
        std::sort(groups.begin(), groups.end(),
                  [](const Group& a, const Group& b) {
                      return a.first < b.first;
                  });
    for (size_t g = 0; g < groups.size(); ++g)
    {
        std::memcpy(out_patterns + g * k, base + (size_t)groups[g].first * k,
                    kb);
        out_weights[g] = groups[g].count;
    }
    *n_patterns_out = (int64_t)groups.size();
    return 0;
}

}  // extern "C"
