import numpy as np

from portbench.corpus import text


def test_same_seed_same_bytes_different_seed_different_bytes():
    a = text.make(300_000, 2**31 + 5)
    assert a == text.make(300_000, 2**31 + 5, threads=1)
    assert len(a) == 300_000
    assert a != text.make(300_000, 2**31 + 6)


def test_words_and_lines_are_the_generators():
    d = text.make(1 << 20, -7)  # any integer seeds it
    lines = d.split(b"\n")[:-1]
    vocab = {w.encode() for w in text.VOCAB}
    for line in lines:
        words = line.split(b" ")
        assert set(words) <= vocab
        # a line ends after the word that takes it past 70 columns, or at a
        # paragraph's end
        assert sum(len(w) + 1 for w in words[:-1]) <= text.COLUMNS
    widths = [len(line) + 1 for line in lines]
    assert np.mean(widths) > text.COLUMNS


def test_line_breaks_rule():
    w = np.array([[30, 30, 11, 5, 70, 2]], np.int16)
    # 30, 60, 71 > 70 (break), 5, 75 > 70 (break), 2 (paragraph end)
    assert text._line_breaks(w).tolist() == [[0, 0, 1, 0, 1, 1]]
