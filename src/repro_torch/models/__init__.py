"""Model substrate: attention (GQA/MQA, MLA), MoE, the recurrent blocks
(RG-LRU, mLSTM, sLSTM), int8 serving and the LM assembly, the enc-dec
stack included; a device mesh waits for ROADMAP A12f."""
