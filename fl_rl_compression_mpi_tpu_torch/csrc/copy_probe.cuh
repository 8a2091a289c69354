// The copy-ceiling probe for Hopper (sm_90a): the plain C interface that
// ops/_build.py loads with ctypes.
//
// y[i] = x[i] + addend (mod 2^32) over nwords u32 words, addend 1 (the
// probe) or 0 (a copy): one read and one write of every word, the least
// work a pass over the stream can do, so its time is the card's achievable
// streaming rate for the benchmark's shapes.
//
// The launcher runs on the stream it is given, allocates nothing, and
// returns cudaGetLastError() (0 on success) as an int.
#pragma once

#include <cstdint>

#ifndef FLRL_API
#define FLRL_API extern "C" __attribute__((visibility("default")))
#endif

// y[i] = x[i] + addend for i in [0, nwords), addend 0 or 1.  Any word
// count and any 4-byte aligned pointers: where x and y are both 16-byte
// aligned the kernel moves 16-byte vectors (the last nwords % 4 words one
// by one), else words.
FLRL_API int flrl_copy_probe(const void* x, void* y, int64_t nwords,
                             int addend, int device, void* stream);
