// Batched Levenshtein edit distance (host-side WER/CER scoring).
//
// TPU-native replacement for the reference's Python edit-distance in
// post_process (WER/CER utils): decode-eval over LibriSpeech-scale corpora
// scores thousands of token sequences per epoch; this OpenMP-parallel C++
// path keeps the host side off the critical path between device steps.
//
// ABI (ctypes): sequences are flattened int32 token arrays with lengths;
// tokens are arbitrary ids (the Python layer interns words/chars to ids).
//
// Built at first use by native/__init__.py (make -C myrtlespeech_tpu_torch/native).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Single pair, two-row DP.
int32_t edit_distance_i32(const int32_t* ref, int32_t ref_len,
                          const int32_t* hyp, int32_t hyp_len) {
  if (ref_len == 0) return hyp_len;
  if (hyp_len == 0) return ref_len;
  std::vector<int32_t> prev(hyp_len + 1), cur(hyp_len + 1);
  for (int32_t j = 0; j <= hyp_len; ++j) prev[j] = j;
  for (int32_t i = 1; i <= ref_len; ++i) {
    cur[0] = i;
    const int32_t r = ref[i - 1];
    for (int32_t j = 1; j <= hyp_len; ++j) {
      const int32_t sub = prev[j - 1] + (r != hyp[j - 1] ? 1 : 0);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[hyp_len];
}

// Batch: refs/hyps are concatenated; *_offsets has n+1 entries.
void edit_distance_batch_i32(const int32_t* refs, const int64_t* ref_offsets,
                             const int32_t* hyps, const int64_t* hyp_offsets,
                             int64_t n, int32_t* out) {
#pragma omp parallel for schedule(dynamic)
  for (int64_t i = 0; i < n; ++i) {
    out[i] = edit_distance_i32(
        refs + ref_offsets[i],
        static_cast<int32_t>(ref_offsets[i + 1] - ref_offsets[i]),
        hyps + hyp_offsets[i],
        static_cast<int32_t>(hyp_offsets[i + 1] - hyp_offsets[i]));
  }
}

}  // extern "C"
