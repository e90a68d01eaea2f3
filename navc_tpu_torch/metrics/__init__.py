"""Caption metrics: PTB-style tokenizer, BLEU, ROUGE-L, CIDEr, METEOR.

Copies of navc_tpu/metrics (the port imports nothing of navc_tpu): BLEU,
ROUGE and CIDEr are ports of the published algorithms, METEOR the METEOR
1.5 model with the vendored tables in ``metrics/data``. The tokenizer and
``COCOScorer`` take the native library's fast paths (``native/lib.py``)
where navc_tpu takes them.
"""

from .tokenizer import ptb_tokenize, tokenize_corpus  # noqa: F401
from .bleu import corpus_bleu  # noqa: F401
from .rouge import corpus_rouge_l  # noqa: F401
from .cider import corpus_cider  # noqa: F401
from .meteor import corpus_meteor  # noqa: F401
from .scorer import COCOScorer  # noqa: F401
