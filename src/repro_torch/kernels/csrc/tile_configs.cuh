// Runtime choice among a kernel's compiled tile configurations.
//
// A kernel lists its configurations as rows of knob values,
//   constexpr int kConfigs[N][K] = {{...}, ...};
// row 0 being its default.  dispatch_config<N>(config, launch) calls
// launch(std::integral_constant<int, i>{}) for row i = config, so that
// each row is a template instantiation compiled from the same source, and
// returns what it returns; an index outside [0, N) launches nothing and
// returns cudaErrorInvalidValue.  copy_configs() writes the rows for the
// kernel's C query (<name>_configs), so that the caller reads the list
// from the library and keeps no copy of its own.
//
// A knob changes how the work is cut into blocks and threads, never the
// order of any output's sum: every configuration gives the same bits.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>
#include <utility>

template <class Launch, std::size_t... I>
int dispatch_config_impl(int config, Launch& launch,
                         std::index_sequence<I...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((config == (int)I
        ? (rc = launch(std::integral_constant<int, (int)I>{}), 0)
        : 0),
   ...);
  return rc;
}

template <std::size_t N, class Launch>
int dispatch_config(int config, Launch&& launch) {
  return dispatch_config_impl(config, launch, std::make_index_sequence<N>{});
}

// Writes at most `capacity` rows of kConfigs into values (row-major) and
// returns the number of rows.
template <std::size_t N, std::size_t K>
int copy_configs(const int (&table)[N][K], int* values, int capacity) {
  for (std::size_t i = 0; i < N && (int)i < capacity; ++i)
    for (std::size_t k = 0; k < K; ++k) values[i * K + k] = table[i][k];
  return (int)N;
}
