"""Model substrate: attention, GQA blocks, int8 serving and the LM
assembly (the dense decoder-only family; MoE, MLA and the recurrent blocks
come with later ROADMAP A12 items)."""
