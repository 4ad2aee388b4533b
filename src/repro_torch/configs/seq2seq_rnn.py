"""The paper's own model (Ono et al. 2019; Luong et al. 2015 global attention).

4-layer stacked-LSTM encoder/decoder, hidden 1024, embeddings 512, joint BPE
vocab 32K, input-feeding OFF (HybridNMT).  ``input_feeding=True`` gives the
baseline / HybridNMTIF variants.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seq2seq-rnn",
    family="seq2seq",
    source="Ono et al. 2019, Table 2 (Luong et al. 2015 attention)",
    num_layers=4,
    d_model=1024,   # LSTM hidden size
    emb_size=512,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=32000,
    input_feeding=False,
    dropout=0.3,
)
