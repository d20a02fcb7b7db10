// Empty kernels that mark where each phase of a captured train or eval step
// begins, and where the step ends (dyglib_tpu_torch/train/phases.py).
//
// A CUDA graph replay calls no Python, so the host ranges that name a
// step's phases (train/sample, train/forward, ...) exist only while the
// step is captured. While it is, each phase also launches its mark kernel
// on the capture stream, so every replay runs the marks in the step's
// order and a profiler trace names them: a phase's device time in a replay
// runs from its mark's start to the next mark's start, and the step_end
// mark closes the last phase. Each mark is one block of one thread that
// does nothing; their names are extern "C" so the trace shows them as
// written.
#include "common.cuh"

#define DYGLIB_MARK(name) extern "C" __global__ void dyglib_mark_##name() {}

DYGLIB_MARK(train_sample)
DYGLIB_MARK(train_forward)
DYGLIB_MARK(train_backward)
DYGLIB_MARK(train_commit)
DYGLIB_MARK(train_optimizer)
DYGLIB_MARK(eval_sample)
DYGLIB_MARK(eval_forward)
DYGLIB_MARK(eval_head)
DYGLIB_MARK(eval_commit)
DYGLIB_MARK(step_end)

namespace {

// in the order of phases.py MARKS (tests/test_torch_spans.py holds them equal)
using Mark = void (*)();
constexpr Mark kMarks[] = {
    dyglib_mark_train_sample, dyglib_mark_train_forward, dyglib_mark_train_backward,
    dyglib_mark_train_commit, dyglib_mark_train_optimizer, dyglib_mark_eval_sample,
    dyglib_mark_eval_forward, dyglib_mark_eval_head, dyglib_mark_eval_commit,
    dyglib_mark_step_end,
};
constexpr int kNumMarks = sizeof(kMarks) / sizeof(kMarks[0]);

}  // namespace

// Launches mark `which` (an index into kMarks) on `stream`.
DYGLIB_API int dyglib_mark(int which, cudaStream_t stream) {
  if (which < 0 || which >= kNumMarks) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kMarks[which]),
                                           dim3(1), dim3(1), nullptr, 0, stream));
}
