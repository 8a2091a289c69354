// Constant-stream FL kernels for Hopper (sm_90a): the plain C interface
// that ops/_build.py loads with ctypes.
//
// A stream whose every byte is one constant c packs, at 128-byte frames, to
// widths all fb = max(1, bitlen(c)) and, where fb divides 8, a payload whose
// every byte is the same pattern byte: c's fb bits repeated 8/fb times.
// Validity (the caller's, asserted here): fb in {1, 2, 4, 8}, and c == 0 or
// n % 128 == 0 (a nonzero constant with a partial tail frame would end in a
// masked byte).
//
// Each launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 on success) as an int.  `flag` is one int32
// that the caller zeroes first; a launch ORs 1 into it on any mismatch.
#pragma once

#include <cstdint>

#ifndef FLRL_API
#define FLRL_API extern "C" __attribute__((visibility("default")))
#endif

// Encode n bytes of `data` speculated constant `cbyte` at width fb: write
// ceil(n/128) widths bytes of fb to `bits` and ceil(n·fb/8) pattern bytes to
// `values`; set *flag when some byte of data differs from cbyte.
FLRL_API int flrl_const_encode(const void* data, int64_t n, int cbyte, int fb,
                               void* bits, void* values, void* flag,
                               int device, void* stream);

// Decode: verify exactly values_size payload bytes of `values` against the
// pattern byte (set *flag on a mismatch) and write n bytes of cbyte to out.
FLRL_API int flrl_const_decode(const void* values, int64_t values_size,
                               int cbyte, int fb, void* out, int64_t n,
                               void* flag, int device, void* stream);
