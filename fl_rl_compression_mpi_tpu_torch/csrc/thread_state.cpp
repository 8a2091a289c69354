// PyTorch's thread-local state, carried from one host thread into another.
//
// ``torch.profiler`` records a thread's ranges only where that thread holds
// the profiler's thread-local state; a thread started after the profiler
// (a mesh's per-card threads) holds none.  PyTorch carries the state into
// its own worker threads with ``at::ThreadLocalStateGuard``; these four
// entry points give the same to ``utils/thread_state.py``, through ctypes.
//
// Built with g++ against the running PyTorch's headers and libraries; no
// CUDA is involved.

#include <ATen/ThreadLocalState.h>

extern "C" {

// The calling thread's state (grad mode, dispatch keys, the profiler's
// state and callbacks), to be released with flrl_state_free.
void* flrl_state_capture() { return new at::ThreadLocalState(); }

void flrl_state_free(void* state) {
  delete static_cast<at::ThreadLocalState*>(state);
}

// Enters ``state`` in the calling thread; returns a guard whose release
// (flrl_state_exit) restores the thread's own state.
void* flrl_state_enter(void* state) {
  return new at::ThreadLocalStateGuard(
      *static_cast<at::ThreadLocalState*>(state));
}

void flrl_state_exit(void* guard) {
  delete static_cast<at::ThreadLocalStateGuard*>(guard);
}

}  // extern "C"
