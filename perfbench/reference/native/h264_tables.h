// Small geometry and context-assignment tables for the H.264 CABAC
// macroblock-layer syntax walk (ITU-T H.264 Tables 9-11, 9-40, 9-42 and the
// 4x4/8x8 block rasterization of clause 6.4.3).
//
// Reference parity: the reference re-derives similar geometry (scan8 grid,
// reference recode.cpp:233-312); here the layout is a plain (x,y) 4x4 grid per
// macroblock, which makes neighbor derivation trivial.
#pragma once

#include <cstdint>

namespace artc {

// Decode order of the 16 luma 4x4 blocks: zigzag of 2x2 quads (clause 6.4.3).
// kBlk4x4X/Y give the block's position in the MB's 4x4 grid.
inline constexpr uint8_t kBlk4x4X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
inline constexpr uint8_t kBlk4x4Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};
// Inverse: 4x4 grid position (x + 4*y) -> decode-order block index.
inline constexpr uint8_t kBlk4x4Idx[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// 8x8 block positions (raster): idx 0..3 -> (x,y) in 8x8 units.
inline constexpr uint8_t kBlk8x8X[4] = {0, 1, 0, 1};
inline constexpr uint8_t kBlk8x8Y[4] = {0, 0, 1, 1};

// Context block categories (Table 9-42), 4:2:0 subset.
enum BlockCat : int {
  kCatLumaDC = 0,   // Intra16x16DCLevel, 16 coeffs
  kCatLumaAC = 1,   // Intra16x16ACLevel, 15 coeffs
  kCatLuma4x4 = 2,  // LumaLevel4x4, 16 coeffs
  kCatChromaDC = 3, // ChromaDCLevel, 4 coeffs (4:2:0)
  kCatChromaAC = 4, // ChromaACLevel, 15 coeffs
  kCatLuma8x8 = 5,  // LumaLevel8x8, 64 coeffs
};

// ctxIdxOffset bases (Table 9-11) and per-category offsets (Table 9-40).
inline constexpr int kCtxCbfBase = 85;           // + 4*cat + inc   (cats 0-4)
inline constexpr int kCtxSigBase = 105;          // frame-coded
inline constexpr int kCtxLastBase = 166;         // frame-coded
inline constexpr int kCtxAbsBase = 227;
inline constexpr int kCtxSig8x8Base = 402;       // frame-coded, cat 5
inline constexpr int kCtxLast8x8Base = 417;      // cat 5
inline constexpr int kCtxAbs8x8Base = 426;       // cat 5
inline constexpr int kCatSigOffset[5] = {0, 15, 29, 44, 47};
inline constexpr int kCatAbsOffset[5] = {0, 10, 20, 30, 39};

// Full ctxIdxOffset assignment by ctxBlockCat 0..13 (cats 6-13 are the
// ChromaArrayType==3 Cb/Cr banks), frame and field rows. Derived from the
// spec's Table 9-40 layout and verified by bank correlation against the
// generated context-init tables (each Cb/Cr bank's init values replicate its
// luma analogue; the three 8x8 coded_block_flag banks fill 1012..1023).
inline constexpr int kCbfCtxBase[14] = {85,  89,  93,  97,  101, 1012, 460,
                                        464, 468, 1016, 472, 476, 480, 1020};
inline constexpr int kSigCtxBase[2][14] = {
    {105, 120, 134, 149, 152, 402, 484, 499, 513, 660, 528, 543, 557, 718},
    {277, 292, 306, 321, 324, 436, 776, 791, 805, 675, 820, 835, 849, 733}};
inline constexpr int kLastCtxBase[2][14] = {
    {166, 181, 195, 210, 213, 417, 572, 587, 601, 690, 616, 631, 645, 748},
    {338, 353, 367, 382, 385, 451, 864, 879, 893, 699, 908, 923, 937, 757}};
inline constexpr int kAbsCtxBase[14] = {227, 237, 247, 257, 266, 426, 952,
                                        962, 972, 708, 982, 992, 1002, 766};

inline constexpr int kCtxMbTypeI = 3;
inline constexpr int kCtxMbSkipP = 11;
inline constexpr int kCtxMbTypeP = 14;
inline constexpr int kCtxSubMbTypeP = 21;
inline constexpr int kCtxMbSkipB = 24;
inline constexpr int kCtxMbTypeB = 27;
inline constexpr int kCtxSubMbTypeB = 36;
inline constexpr int kCtxMvdX = 40;
inline constexpr int kCtxMvdY = 47;
inline constexpr int kCtxRefIdx = 54;
inline constexpr int kCtxQpDelta = 60;
inline constexpr int kCtxChromaPred = 64;
inline constexpr int kCtxIntra4x4PredFlag = 68;
inline constexpr int kCtxIntra4x4PredRem = 69;
inline constexpr int kCtxMbField = 70;          // mb_field_decoding_flag (MBAFF)
inline constexpr int kCtxCbpLuma = 73;
inline constexpr int kCtxCbpChroma = 77;
inline constexpr int kCtxEndOfSlice = 276;
inline constexpr int kCtxSigBaseField = 277;     // field-coded MBs (MBAFF/PAFF)
inline constexpr int kCtxLastBaseField = 338;
inline constexpr int kCtxSig8x8BaseField = 436;
inline constexpr int kCtxLast8x8BaseField = 451;
inline constexpr int kCtxTransform8x8 = 399;

// Pseudo context ids for the recode model (mirrors the reference's dummy
// bypass/terminate context addresses, reference recode.cpp:1049).
inline constexpr int kCtxBypass = 1024;
inline constexpr int kCtxTerminate = 1025;
inline constexpr int kNumModelContexts = 1026;

// Per-MB residual block slots for the nonzero-count frame buffer (our
// equivalent of the reference's scan8-indexed Block/BlockMeta store,
// reference block.h:4-23). 31 slots cover 4:2:0.
enum BlockSlot : int {
  kSlotLumaDC = 0,
  kSlotLuma4x4 = 1,   // +blk_idx (0..15)
  kSlotLuma8x8 = 17,  // +blk8x8 (0..3)
  kSlotChromaDC = 21, // +component (0..1)
  kSlotChromaAC = 23, // +component*8+blk (blk 0..3 for 4:2:0, 0..7 for 4:2:2)
  // ChromaArrayType==3 (4:4:4): Cb/Cr planes carry luma-shaped block sets.
  kSlotPlaneDC = 39,   // +(comp-1)*21
  kSlotPlane4x4 = 40,  // +(comp-1)*21 + blk (0..15)
  kSlotPlane8x8 = 56,  // +(comp-1)*21 + blk8x8 (0..3)
  kNumBlockSlots = 81,
};

}  // namespace artc
