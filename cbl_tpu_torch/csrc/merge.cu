// Kernel B3: merge of two sorted runs of int64 key rows (merge path).
//
// Replaces the TPU kernel cbl_tpu/ops/merge_pallas.py `merge_sorted_cols`
// (`_coranks`, `_merge_params`, `_merge_call`, `_flip_pad_cols`).  Given a
// and b, each sorted ascending (rows of one to three int64 columns,
// compared lexicographically, column 0 major: a word of one or two columns,
// and a tag, a position or a seqtag), it writes their merge, equal to
// sort(concat(a, b)).
//
// What bounds it on the H100: device memory, 8 bytes read and 8 written
// per output key and column.  The design follows the TPU kernel's co-rank
// partition but not its frame: the TPU merged each tile with a bitonic
// network over a flipped copy of b, a workaround for its vector unit; here
// each thread merges its items one by one (merge_path.cuh, which kernel B5
// shares).

#include "merge_path.cuh"

namespace {

template <int C>
int merge_sorted(const void* const* a, long long na, const void* const* b,
                 long long nb, void* const* out, void* coranks,
                 cudaStream_t s) {
  cbl::Cols<C> ca, cb;
  cbl::MutCols<C> co;
  for (int c = 0; c < C; ++c) {
    ca.p[c] = (const long long*)a[c];
    cb.p[c] = (const long long*)b[c];
    co.p[c] = (long long*)out[c];
  }
  const long long n_tiles = (na + nb + cbl::kTile - 1) / cbl::kTile;
  const cbl::Pairs ps{0, 0, na, nb};
  return (int)cbl::merge_pass<C>(ca, cb, ps, n_tiles, (long long*)coranks, co,
                                 s);
}

}  // namespace

// a, b and out are C-element arrays of column pointers (C = 1 to 3).
// `coranks` is scratch for one int64 per output tile.
extern "C" int cbl_merge_sorted(const void* const* a, long long na,
                                const void* const* b, long long nb,
                                void* const* out, int C, void* coranks,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return merge_sorted<1>(a, na, b, nb, out, coranks, s);
    case 2:
      return merge_sorted<2>(a, na, b, nb, out, coranks, s);
    case 3:
      return merge_sorted<3>(a, na, b, nb, out, coranks, s);
  }
  return (int)cudaErrorInvalidValue;
}
