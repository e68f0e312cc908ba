// Reads the floating-point state of every thread of an OpenMP parallel
// region: each thread stores its MXCSR (SSE rounding, flush-to-zero,
// denormals-are-zero), fegetround() and its kernel thread id. Built by
// scripts/repeat_cross_check.py with -fopenmp; where the process's
// libgomp is torch's, the region's threads are torch's intra-op workers.
#include <cfenv>
#include <dlfcn.h>
#include <omp.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <xmmintrin.h>

extern "C" int otto_thread_fp_state(int n, unsigned* mxcsr, int* round, long* tid) {
  int seen = 0;
#pragma omp parallel num_threads(n)
  {
    int i = omp_get_thread_num();
    if (i < n) {
      mxcsr[i] = _mm_getcsr();
      round[i] = fegetround();
      tid[i] = syscall(SYS_gettid);
    }
#pragma omp atomic
    seen++;
  }
  return seen;
}

// The path of the shared object that serves omp_get_thread_num here.
extern "C" const char* otto_omp_library(void) {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&omp_get_thread_num), &info) && info.dli_fname)
    return info.dli_fname;
  return "";
}
