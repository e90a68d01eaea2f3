"""Special token ids and loss-key mapping.

Capability parity with reference config/Constants.py:1-21 (token ids and the
crit-name -> (prediction key, target key) mapping) and the Penn-Treebank ->
universal POS-tag mapping (config/Constants.py:24-46) used by corpus
preparation and visual-word supervision.
"""

PAD = 0
UNK = 1
BOS = 2
EOS = 3
MASK = 4
VIS = 5

PAD_WORD = "<pad>"
UNK_WORD = "<unk>"
BOS_WORD = "<bos>"
EOS_WORD = "<eos>"
MASK_WORD = "<mask>"
VIS_WORD = "<vis>"

NUM_SPECIAL_TOKENS = 6

SPECIAL_TOKEN_WORDS = {
    PAD: PAD_WORD,
    UNK: UNK_WORD,
    BOS: BOS_WORD,
    EOS: EOS_WORD,
    MASK: MASK_WORD,
    VIS: VIS_WORD,
}

# crit name -> (key of model prediction, key of ground truth) in the results
# dict produced by a forward pass (reference config/Constants.py:15-18).
mapping = {
    "lang": ("tgt_word_logprobs", "tgt_word_labels"),
    "length": ("pred_length", "tgt_length"),
}

# Penn-Treebank tag -> universal POS tag (reference config/Constants.py:24-46).
_POS_CONTENT = [
    [["``", "''", ",", "-LRB-", "-RRB-", ".", ":", "HYPH", "NFP"], "PUNCT"],
    [["$", "SYM"], "SYM"],
    [["VB", "VBD", "VBG", "VBN", "VBP", "VBZ", "MD"], "VERB"],
    [["WDT", "WP$", "PRP$", "DT", "PDT"], "DET"],
    [["NN", "NNP", "NNPS", "NNS"], "NOUN"],
    [["WP", "EX", "PRP"], "PRON"],
    [["JJ", "JJR", "JJS", "AFX"], "ADJ"],
    [["ADD", "FW", "GW", "LS", "NIL", "XX"], "X"],
    [["SP", "_SP"], "SPACE"],
    [["RB", "RBR", "RBS", "WRB"], "ADV"],
    [["IN", "RP"], "ADP"],
    [["CC"], "CCONJ"],
    [["CD"], "NUM"],
    [["POS", "TO"], "PART"],
    [["UH"], "INTJ"],
]

pos_tag_mapping = {}
for _tags, _universal in _POS_CONTENT:
    for _t in _tags:
        pos_tag_mapping[_t] = _universal

# Verbs excluded from visual-word supervision (reference dataloader.py:408).
IGNORED_VISUAL_WORDS = ("is", "are", "was", "were", "be")
