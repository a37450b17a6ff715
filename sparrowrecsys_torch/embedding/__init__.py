"""The embedding pretraining plane: the port of `sparrowrecsys_tpu/embedding`
(item2vec, DeepWalk, user embeddings, LSH and the artifact files), run on
the card unless the caller asks for the CPU."""

from sparrowrecsys_torch.embedding.artifacts import (
    load_embeddings_csv,
    write_embeddings_csv,
)
from sparrowrecsys_torch.embedding.deepwalk import (
    DeepWalkConfig,
    random_walks,
    train_deepwalk,
    transition_matrix,
)
from sparrowrecsys_torch.embedding.item2vec import (
    Item2VecConfig,
    build_item_sequences,
    skipgram_pairs,
    train_item2vec,
)
from sparrowrecsys_torch.embedding.lsh import LSHIndex
from sparrowrecsys_torch.embedding.user_emb import generate_user_emb
