"""Native (C++) caption metrics: the PTB tokenizer and the scorers, via ctypes."""
