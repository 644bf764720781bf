"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the
700 W power limit). A card set below that limit runs under them, so every
share is reported with the card's power limit beside it."""

BF16_FLOP_PER_S = 989e12      # tensor cores, bf16 in, f32 accumulate
HBM_BYTES_PER_S = 3.35e12     # HBM3
