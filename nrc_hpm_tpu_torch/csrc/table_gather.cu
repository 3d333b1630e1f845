// Random lookups into small tables: kernels K5 (table_gather) and K6
// (small_table_lookup).  out[i] = table[idx[i]] for 32-bit tables.
//
// K5 replaces the Pallas kernel nrc_hpm_tpu/ops/table_gather.py:_kernel
// (wrapper table_gather): the coarse-profile lookups of the piecewise
// trackers into the 3,520-word bf16-packed macrocell table
// (volume.macro_profile_xyz), any table of <= 65,536 entries.  K6 replaces
// nrc_hpm_tpu/ops/macro_gather.py:_kernel (wrapper small_table_lookup): the
// float32 majorant and control lookups of volume.macro_sigma /
// macro_control, tables of <= 8,192 entries.
//
// The TPU kernels sweep the table's rows through a 128-lane window because
// the TPU has no vector gather; on the H100 a gather is one load per index
// and none of that is ported.  What bounds them: 4 bytes of index read and
// 4 bytes written per lookup against one random 4-byte read from a table
// of at most 256 KB, so device-memory bandwidth on the index and output
// streams (8 bytes a lookup), as long as the table reads hit on chip.  K5
// reads its table through the read-only cache (__ldg); K6 stages its table
// of at most 32 KB in shared memory once per persistent block.  Words are
// copied as bits, so both are bitwise equal to table[idx].  Indices outside
// [0, T) give 0 (the callers clamp theirs into the table).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GATHER = 65536;
constexpr int MAX_SMALL = 8192;

__global__ void __launch_bounds__(THREADS)
table_gather_kernel(const uint32_t* __restrict__ table, int n_table,
                    const int* __restrict__ idx, long long n,
                    uint32_t* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = __ldg(idx + i);
    out[i] = (unsigned)k < (unsigned)n_table ? __ldg(table + k) : 0u;
  }
}

__global__ void __launch_bounds__(THREADS)
small_table_lookup_kernel(const uint32_t* __restrict__ table, int n_table,
                          const int* __restrict__ idx, long long n,
                          uint32_t* __restrict__ out) {
  __shared__ uint32_t tbl[MAX_SMALL];
  for (int i = threadIdx.x; i < n_table; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = __ldg(idx + i);
    out[i] = (unsigned)k < (unsigned)n_table ? tbl[k] : 0u;
  }
}

int grid_for(long long n, int per_sm) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return -1;
  const long long tiles = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * per_sm;
  return (int)(tiles < cap ? tiles : cap);
}

}  // namespace

extern "C" int table_gather_launch(const void* table, int n_table,
                                   const void* idx, long long n, void* out,
                                   void* stream) {
  if (n_table < 1 || n_table > MAX_GATHER || n < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = grid_for(n, 16);
  if (blocks < 1) return (int)cudaErrorInvalidDevice;
  table_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, n_table, (const int*)idx, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int small_table_lookup_launch(const void* table, int n_table,
                                         const void* idx, long long n,
                                         void* out, void* stream) {
  if (n_table < 1 || n_table > MAX_SMALL || n < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = grid_for(n, 4);
  if (blocks < 1) return (int)cudaErrorInvalidDevice;
  small_table_lookup_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, n_table, (const int*)idx, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* table_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
