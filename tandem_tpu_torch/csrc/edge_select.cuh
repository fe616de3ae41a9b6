// Generated by python -m tandem_tpu_torch.ops.selection_network;
// do not edit. Parberry's pairwise sorting network for 32 inputs,
// wires 24-31 held at +inf, pruned to output wire 13: the
// 13th smallest (0-indexed) of 24 values in 94 comparators,
// 165 fminf/fmaxf. Only fminf/fmaxf move values, so the result is
// one of the inputs bit for bit, for any ties.
#pragma once

__device__ __forceinline__ float select_rank13_of24(float (&v)[24]) {
  { const float t = v[0]; v[0] = fminf(t, v[1]); v[1] = fmaxf(t, v[1]); }
  { const float t = v[2]; v[2] = fminf(t, v[3]); v[3] = fmaxf(t, v[3]); }
  { const float t = v[4]; v[4] = fminf(t, v[5]); v[5] = fmaxf(t, v[5]); }
  { const float t = v[6]; v[6] = fminf(t, v[7]); v[7] = fmaxf(t, v[7]); }
  { const float t = v[8]; v[8] = fminf(t, v[9]); v[9] = fmaxf(t, v[9]); }
  { const float t = v[10]; v[10] = fminf(t, v[11]); v[11] = fmaxf(t, v[11]); }
  { const float t = v[12]; v[12] = fminf(t, v[13]); v[13] = fmaxf(t, v[13]); }
  { const float t = v[14]; v[14] = fminf(t, v[15]); v[15] = fmaxf(t, v[15]); }
  { const float t = v[16]; v[16] = fminf(t, v[17]); v[17] = fmaxf(t, v[17]); }
  { const float t = v[18]; v[18] = fminf(t, v[19]); v[19] = fmaxf(t, v[19]); }
  { const float t = v[20]; v[20] = fminf(t, v[21]); v[21] = fmaxf(t, v[21]); }
  { const float t = v[22]; v[22] = fminf(t, v[23]); v[23] = fmaxf(t, v[23]); }
  { const float t = v[0]; v[0] = fminf(t, v[2]); v[2] = fmaxf(t, v[2]); }
  { const float t = v[1]; v[1] = fminf(t, v[3]); v[3] = fmaxf(t, v[3]); }
  { const float t = v[4]; v[4] = fminf(t, v[6]); v[6] = fmaxf(t, v[6]); }
  { const float t = v[5]; v[5] = fminf(t, v[7]); v[7] = fmaxf(t, v[7]); }
  { const float t = v[8]; v[8] = fminf(t, v[10]); v[10] = fmaxf(t, v[10]); }
  { const float t = v[9]; v[9] = fminf(t, v[11]); v[11] = fmaxf(t, v[11]); }
  { const float t = v[12]; v[12] = fminf(t, v[14]); v[14] = fmaxf(t, v[14]); }
  { const float t = v[13]; v[13] = fminf(t, v[15]); v[15] = fmaxf(t, v[15]); }
  { const float t = v[16]; v[16] = fminf(t, v[18]); v[18] = fmaxf(t, v[18]); }
  { const float t = v[17]; v[17] = fminf(t, v[19]); v[19] = fmaxf(t, v[19]); }
  { const float t = v[20]; v[20] = fminf(t, v[22]); v[22] = fmaxf(t, v[22]); }
  { const float t = v[21]; v[21] = fminf(t, v[23]); v[23] = fmaxf(t, v[23]); }
  { const float t = v[0]; v[0] = fminf(t, v[4]); v[4] = fmaxf(t, v[4]); }
  { const float t = v[1]; v[1] = fminf(t, v[5]); v[5] = fmaxf(t, v[5]); }
  { const float t = v[2]; v[2] = fminf(t, v[6]); v[6] = fmaxf(t, v[6]); }
  { const float t = v[3]; v[3] = fminf(t, v[7]); v[7] = fmaxf(t, v[7]); }
  { const float t = v[8]; v[8] = fminf(t, v[12]); v[12] = fmaxf(t, v[12]); }
  { const float t = v[9]; v[9] = fminf(t, v[13]); v[13] = fmaxf(t, v[13]); }
  { const float t = v[10]; v[10] = fminf(t, v[14]); v[14] = fmaxf(t, v[14]); }
  { const float t = v[11]; v[11] = fminf(t, v[15]); v[15] = fmaxf(t, v[15]); }
  { const float t = v[16]; v[16] = fminf(t, v[20]); v[20] = fmaxf(t, v[20]); }
  { const float t = v[17]; v[17] = fminf(t, v[21]); v[21] = fmaxf(t, v[21]); }
  { const float t = v[18]; v[18] = fminf(t, v[22]); v[22] = fmaxf(t, v[22]); }
  { const float t = v[19]; v[19] = fminf(t, v[23]); v[23] = fmaxf(t, v[23]); }
  { const float t = v[0]; v[0] = fminf(t, v[8]); v[8] = fmaxf(t, v[8]); }
  { const float t = v[1]; v[1] = fminf(t, v[9]); v[9] = fmaxf(t, v[9]); }
  { const float t = v[2]; v[2] = fminf(t, v[10]); v[10] = fmaxf(t, v[10]); }
  { const float t = v[3]; v[3] = fminf(t, v[11]); v[11] = fmaxf(t, v[11]); }
  { const float t = v[4]; v[4] = fminf(t, v[12]); v[12] = fmaxf(t, v[12]); }
  { const float t = v[5]; v[5] = fminf(t, v[13]); v[13] = fmaxf(t, v[13]); }
  { const float t = v[6]; v[6] = fminf(t, v[14]); v[14] = fmaxf(t, v[14]); }
  v[7] = fminf(v[7], v[15]);
  v[16] = fmaxf(v[0], v[16]);
  { const float t = v[1]; v[1] = fminf(t, v[17]); v[17] = fmaxf(t, v[17]); }
  { const float t = v[2]; v[2] = fminf(t, v[18]); v[18] = fmaxf(t, v[18]); }
  { const float t = v[3]; v[3] = fminf(t, v[19]); v[19] = fmaxf(t, v[19]); }
  { const float t = v[4]; v[4] = fminf(t, v[20]); v[20] = fmaxf(t, v[20]); }
  { const float t = v[5]; v[5] = fminf(t, v[21]); v[21] = fmaxf(t, v[21]); }
  { const float t = v[6]; v[6] = fminf(t, v[22]); v[22] = fmaxf(t, v[22]); }
  v[7] = fminf(v[7], v[23]);
  v[16] = fmaxf(v[8], v[16]);
  { const float t = v[9]; v[9] = fminf(t, v[17]); v[17] = fmaxf(t, v[17]); }
  { const float t = v[10]; v[10] = fminf(t, v[18]); v[18] = fmaxf(t, v[18]); }
  { const float t = v[11]; v[11] = fminf(t, v[19]); v[19] = fmaxf(t, v[19]); }
  { const float t = v[12]; v[12] = fminf(t, v[20]); v[20] = fmaxf(t, v[20]); }
  { const float t = v[13]; v[13] = fminf(t, v[21]); v[21] = fmaxf(t, v[21]); }
  { const float t = v[14]; v[14] = fminf(t, v[22]); v[22] = fmaxf(t, v[22]); }
  v[16] = fmaxf(v[4], v[16]);
  { const float t = v[5]; v[5] = fminf(t, v[17]); v[17] = fmaxf(t, v[17]); }
  { const float t = v[6]; v[6] = fminf(t, v[18]); v[18] = fmaxf(t, v[18]); }
  v[7] = fminf(v[7], v[19]);
  { const float t = v[5]; v[5] = fminf(t, v[9]); v[9] = fmaxf(t, v[9]); }
  { const float t = v[6]; v[6] = fminf(t, v[10]); v[10] = fmaxf(t, v[10]); }
  { const float t = v[7]; v[7] = fminf(t, v[11]); v[11] = fmaxf(t, v[11]); }
  v[16] = fmaxf(v[12], v[16]);
  { const float t = v[13]; v[13] = fminf(t, v[17]); v[17] = fmaxf(t, v[17]); }
  { const float t = v[14]; v[14] = fminf(t, v[18]); v[18] = fmaxf(t, v[18]); }
  v[16] = fmaxf(v[2], v[16]);
  { const float t = v[3]; v[3] = fminf(t, v[17]); v[17] = fmaxf(t, v[17]); }
  v[20] = fmaxf(v[6], v[20]);
  v[7] = fminf(v[7], v[21]);
  { const float t = v[3]; v[3] = fminf(t, v[9]); v[9] = fmaxf(t, v[9]); }
  { const float t = v[7]; v[7] = fminf(t, v[13]); v[13] = fmaxf(t, v[13]); }
  v[16] = fmaxf(v[10], v[16]);
  v[11] = fminf(v[11], v[17]);
  { const float t = v[14]; v[14] = fminf(t, v[20]); v[20] = fmaxf(t, v[20]); }
  { const float t = v[3]; v[3] = fminf(t, v[5]); v[5] = fmaxf(t, v[5]); }
  { const float t = v[7]; v[7] = fminf(t, v[9]); v[9] = fmaxf(t, v[9]); }
  { const float t = v[11]; v[11] = fminf(t, v[13]); v[13] = fmaxf(t, v[13]); }
  { const float t = v[14]; v[14] = fminf(t, v[16]); v[16] = fmaxf(t, v[16]); }
  { const float t = v[18]; v[18] = fminf(t, v[20]); v[20] = fmaxf(t, v[20]); }
  v[16] = fmaxf(v[1], v[16]);
  v[18] = fmaxf(v[3], v[18]);
  v[20] = fmaxf(v[5], v[20]);
  v[7] = fminf(v[7], v[22]);
  v[14] = fmaxf(v[7], v[14]);
  v[16] = fmaxf(v[9], v[16]);
  v[11] = fminf(v[11], v[18]);
  v[13] = fminf(v[13], v[20]);
  v[14] = fmaxf(v[11], v[14]);
  v[13] = fminf(v[13], v[16]);
  v[13] = fminf(v[13], v[14]);
  return v[13];
}
