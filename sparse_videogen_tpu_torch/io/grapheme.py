"""Extended grapheme clusters (Unicode UAX #29) in the standard library, for
the precompiled charsmap of io/tokenizer.py.

`tokenizers`' Precompiled normalizer, which the JAX package applies to
UMT5 prompts, looks its replacements up one extended grapheme cluster at a
time (the `unicode-segmentation` crate, Unicode 16.0). Python's standard
library has no Grapheme_Cluster_Break property, and the card's host has no
`regex` package, so the classes are range tables of this module: hex code
point ranges of Unicode 16.0's Grapheme_Cluster_Break and
Extended_Pictographic values (3,537 code points), which `tokenizers`
follows. Hangul LV / LVT syllables are computed. The tables were checked
code point by code point against tokenizers' Precompiled wherever a class
shows in its output (tests/test_torch_charsmap.py holds samples of each).

Rules: GB3-GB9b, GB11 (emoji ZWJ sequences) and GB12/13 (regional
indicator pairs). GB9c (Indic conjunct clusters: consonant, virama,
consonant) is not applied: each cluster it joins is 9 bytes or more, and
the normalizer looks those up a character at a time either way.
"""

from __future__ import annotations

import bisect

_PREPEND = """
    600-605 6DD 70F 890-891 8E2 D4E 110BD 110CD 111C2-111C3 113D1 1193F 11941 11A3A 11A84-11A89 11D46 11F02
"""

_CONTROL = """
    0-9 B-C E-1F 7F-9F AD 61C 180E 200B 200E-200F 2028-202E 2060-206F FEFF FFF0-FFFB 13430-1343F 1BCA0-1BCA3
    1D173-1D17A E0000-E001F E0080-E00FF E01F0-E0FFF
"""

_EXTEND = """
    300-36F 483-489 591-5BD 5BF 5C1-5C2 5C4-5C5 5C7 610-61A 64B-65F 670 6D6-6DC 6DF-6E4 6E7-6E8 6EA-6ED 711
    730-74A 7A6-7B0 7EB-7F3 7FD 816-819 81B-823 825-827 829-82D 859-85B 897-89F 8CA-8E1 8E3-902 93A 93C
    941-948 94D 951-957 962-963 981 9BC 9BE 9C1-9C4 9CD 9D7 9E2-9E3 9FE A01-A02 A3C A41-A42 A47-A48 A4B-A4D
    A51 A70-A71 A75 A81-A82 ABC AC1-AC5 AC7-AC8 ACD AE2-AE3 AFA-AFF B01 B3C B3E-B3F B41-B44 B4D B55-B57
    B62-B63 B82 BBE BC0 BCD BD7 C00 C04 C3C C3E-C40 C46-C48 C4A-C4D C55-C56 C62-C63 C81 CBC CBF-CC0 CC2
    CC6-CC8 CCA-CCD CD5-CD6 CE2-CE3 D00-D01 D3B-D3C D3E D41-D44 D4D D57 D62-D63 D81 DCA DCF DD2-DD4 DD6 DDF
    E31 E34-E3A E47-E4E EB1 EB4-EBC EC8-ECE F18-F19 F35 F37 F39 F71-F7E F80-F84 F86-F87 F8D-F97 F99-FBC FC6
    102D-1030 1032-1037 1039-103A 103D-103E 1058-1059 105E-1060 1071-1074 1082 1085-1086 108D 109D 135D-135F
    1712-1715 1732-1734 1752-1753 1772-1773 17B4-17B5 17B7-17BD 17C6 17C9-17D3 17DD 180B-180D 180F 1885-1886
    18A9 1920-1922 1927-1928 1932 1939-193B 1A17-1A18 1A1B 1A56 1A58-1A5E 1A60 1A62 1A65-1A6C 1A73-1A7C 1A7F
    1AB0-1ACE 1B00-1B03 1B34-1B3D 1B42-1B44 1B6B-1B73 1B80-1B81 1BA2-1BA5 1BA8-1BAD 1BE6 1BE8-1BE9 1BED
    1BEF-1BF3 1C2C-1C33 1C36-1C37 1CD0-1CD2 1CD4-1CE0 1CE2-1CE8 1CED 1CF4 1CF8-1CF9 1DC0-1DFF 200C 20D0-20F0
    2CEF-2CF1 2D7F 2DE0-2DFF 302A-302F 3099-309A A66F-A672 A674-A67D A69E-A69F A6F0-A6F1 A802 A806 A80B
    A825-A826 A82C A8C4-A8C5 A8E0-A8F1 A8FF A926-A92D A947-A951 A953 A980-A982 A9B3 A9B6-A9B9 A9BC-A9BD A9C0
    A9E5 AA29-AA2E AA31-AA32 AA35-AA36 AA43 AA4C AA7C AAB0 AAB2-AAB4 AAB7-AAB8 AABE-AABF AAC1 AAEC-AAED AAF6
    ABE5 ABE8 ABED FB1E FE00-FE0F FE20-FE2F FF9E-FF9F 101FD 102E0 10376-1037A 10A01-10A03 10A05-10A06
    10A0C-10A0F 10A38-10A3A 10A3F 10AE5-10AE6 10D24-10D27 10D69-10D6D 10EAB-10EAC 10EFC-10EFF 10F46-10F50
    10F82-10F85 11001 11038-11046 11070 11073-11074 1107F-11081 110B3-110B6 110B9-110BA 110C2 11100-11102
    11127-1112B 1112D-11134 11173 11180-11181 111B6-111BE 111C0 111C9-111CC 111CF 1122F-11231 11234-11237
    1123E 11241 112DF 112E3-112EA 11300-11301 1133B-1133C 1133E 11340 1134D 11357 11366-1136C 11370-11374
    113B8 113BB-113C0 113C2 113C5 113C7-113C9 113CE-113D0 113D2 113E1-113E2 11438-1143F 11442-11444 11446
    1145E 114B0 114B3-114B8 114BA 114BD 114BF-114C0 114C2-114C3 115AF 115B2-115B5 115BC-115BD 115BF-115C0
    115DC-115DD 11633-1163A 1163D 1163F-11640 116AB 116AD 116B0-116B7 1171D 1171F 11722-11725 11727-1172B
    1182F-11837 11839-1183A 11930 1193B-1193E 11943 119D4-119D7 119DA-119DB 119E0 11A01-11A0A 11A33-11A38
    11A3B-11A3E 11A47 11A51-11A56 11A59-11A5B 11A8A-11A96 11A98-11A99 11C30-11C36 11C38-11C3D 11C3F
    11C92-11CA7 11CAA-11CB0 11CB2-11CB3 11CB5-11CB6 11D31-11D36 11D3A 11D3C-11D3D 11D3F-11D45 11D47
    11D90-11D91 11D95 11D97 11EF3-11EF4 11F00-11F01 11F36-11F3A 11F40-11F42 11F5A 13440 13447-13455
    1611E-16129 1612D-1612F 16AF0-16AF4 16B30-16B36 16F4F 16F8F-16F92 16FE4 16FF0-16FF1 1BC9D-1BC9E
    1CF00-1CF2D 1CF30-1CF46 1D165-1D169 1D16D-1D172 1D17B-1D182 1D185-1D18B 1D1AA-1D1AD 1D242-1D244
    1DA00-1DA36 1DA3B-1DA6C 1DA75 1DA84 1DA9B-1DA9F 1DAA1-1DAAF 1E000-1E006 1E008-1E018 1E01B-1E021
    1E023-1E024 1E026-1E02A 1E08F 1E130-1E136 1E2AE 1E2EC-1E2EF 1E4EC-1E4EF 1E5EE-1E5EF 1E8D0-1E8D6
    1E944-1E94A 1F3FB-1F3FF E0020-E007F E0100-E01EF
"""

_SPACING_MARK = """
    903 93B 93E-940 949-94C 94E-94F 982-983 9BF-9C0 9C7-9C8 9CB-9CC A03 A3E-A40 A83 ABE-AC0 AC9 ACB-ACC
    B02-B03 B40 B47-B48 B4B-B4C BBF BC1-BC2 BC6-BC8 BCA-BCC C01-C03 C41-C44 C82-C83 CBE CC1 CC3-CC4 CF3
    D02-D03 D3F-D40 D46-D48 D4A-D4C D82-D83 DD0-DD1 DD8-DDE DF2-DF3 E33 EB3 F3E-F3F F7F 1031 103B-103C
    1056-1057 1084 17B6 17BE-17C5 17C7-17C8 1923-1926 1929-192B 1930-1931 1933-1938 1A19-1A1A 1A55 1A57
    1A6D-1A72 1B04 1B3E-1B41 1B82 1BA1 1BA6-1BA7 1BE7 1BEA-1BEC 1BEE 1C24-1C2B 1C34-1C35 1CE1 1CF7 A823-A824
    A827 A880-A881 A8B4-A8C3 A952 A983 A9B4-A9B5 A9BA-A9BB A9BE-A9BF AA2F-AA30 AA33-AA34 AA4D AAEB AAEE-AAEF
    AAF5 ABE3-ABE4 ABE6-ABE7 ABE9-ABEA ABEC 11000 11002 11082 110B0-110B2 110B7-110B8 1112C 11145-11146
    11182 111B3-111B5 111BF 111CE 1122C-1122E 11232-11233 112E0-112E2 11302-11303 1133F 11341-11344
    11347-11348 1134B-1134C 11362-11363 113B9-113BA 113CA 113CC-113CD 11435-11437 11440-11441 11445
    114B1-114B2 114B9 114BB-114BC 114BE 114C1 115B0-115B1 115B8-115BB 115BE 11630-11632 1163B-1163C 1163E
    116AC 116AE-116AF 1171E 11726 1182C-1182E 11838 11931-11935 11937-11938 11940 11942 119D1-119D3
    119DC-119DF 119E4 11A39 11A57-11A58 11A97 11C2F 11C3E 11CA9 11CB1 11CB4 11D8A-11D8E 11D93-11D94 11D96
    11EF5-11EF6 11F03 11F34-11F35 11F3E-11F3F 1612A-1612C 16F51-16F87
"""

_HANGUL_L = """
    1100-115F A960-A97C
"""

_HANGUL_V = """
    1160-11A7 D7B0-D7C6 16D63 16D67-16D6A
"""

_HANGUL_T = """
    11A8-11FF D7CB-D7FB
"""

_EXT_PICT = """
    A9 AE 203C 2049 2122 2139 2194-2199 21A9-21AA 231A-231B 2328 2388 23CF 23E9-23F3 23F8-23FA 24C2
    25AA-25AB 25B6 25C0 25FB-25FE 2600-2605 2607-2612 2614-2685 2690-2705 2708-2712 2714 2716 271D 2721 2728
    2733-2734 2744 2747 274C 274E 2753-2755 2757 2763-2767 2795-2797 27A1 27B0 27BF 2934-2935 2B05-2B07
    2B1B-2B1C 2B50 2B55 3030 303D 3297 3299 1F000-1F0FF 1F10D-1F10F 1F12F 1F16C-1F171 1F17E-1F17F 1F18E
    1F191-1F19A 1F1AD-1F1E5 1F201-1F20F 1F21A 1F22F 1F232-1F23A 1F23C-1F23F 1F249-1F3FA 1F400-1F53D
    1F546-1F64F 1F680-1F6FF 1F774-1F77F 1F7D5-1F7FF 1F80C-1F80F 1F848-1F84F 1F85A-1F85F 1F888-1F88F
    1F8AE-1F8FF 1F90C-1F93A 1F93C-1F945 1F947-1FAFF 1FC00-1FFFD
"""

CR, LF, ZWJ = 0x0D, 0x0A, 0x200D
RI_FIRST, RI_LAST = 0x1F1E6, 0x1F1FF
SYL_FIRST, SYL_LAST = 0xAC00, 0xD7A3  # Hangul syllables: LV when (cp - SYL_FIRST) % 28 == 0, else LVT
(OTHER, C_CR, C_LF, CONTROL, EXTEND, C_ZWJ, RI, PREPEND, SPACING_MARK,
 L, V, T, LV, LVT) = range(14)


def _parse(table: str) -> list[tuple[int, int]]:
    out = []
    for tok in table.split():
        lo, _, hi = tok.partition("-")
        out.append((int(lo, 16), int(hi or lo, 16)))
    return out


def _merge(*classed) -> tuple[list[int], list[int], list[int]]:
    """(starts, ends, classes) of the disjoint ranges, sorted."""
    rows = sorted((lo, hi, c) for c, table in classed for lo, hi in _parse(table))
    for (_, hi, _), (lo, _, _) in zip(rows, rows[1:]):
        if lo <= hi:
            raise ValueError("overlapping grapheme ranges")
    return [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows]


_STARTS, _ENDS, _CLASSES = _merge((PREPEND, _PREPEND), (CONTROL, _CONTROL), (EXTEND, _EXTEND),
                                  (SPACING_MARK, _SPACING_MARK), (L, _HANGUL_L), (V, _HANGUL_V), (T, _HANGUL_T))
_PICT_STARTS, _PICT_ENDS, _ = _merge((1, _EXT_PICT))


def _find(starts, ends, cp: int) -> int:
    i = bisect.bisect_right(starts, cp) - 1
    return i if i >= 0 and cp <= ends[i] else -1


def break_class(cp: int) -> int:
    """The Grapheme_Cluster_Break class of a code point (one of the
    constants above)."""
    if cp == CR:
        return C_CR
    if cp == LF:
        return C_LF
    if cp == ZWJ:
        return C_ZWJ
    if RI_FIRST <= cp <= RI_LAST:
        return RI
    if SYL_FIRST <= cp <= SYL_LAST:
        return LV if (cp - SYL_FIRST) % 28 == 0 else LVT
    i = _find(_STARTS, _ENDS, cp)
    return OTHER if i < 0 else _CLASSES[i]


def extended_pictographic(cp: int) -> bool:
    return _find(_PICT_STARTS, _PICT_ENDS, cp) >= 0


_HARD = (CONTROL, C_CR, C_LF)


def graphemes(text: str) -> list[str]:
    """The extended grapheme clusters of `text`, in order."""
    out, start = [], 0
    prev = None
    ri_run = 0  # regional indicators in a row, up to and including the previous character
    emoji = 0  # 1 after ExtPict Extend*, 2 after ExtPict Extend* ZWJ
    for i, ch in enumerate(text):
        cp = ord(ch)
        cls, pict = break_class(cp), extended_pictographic(cp)
        if prev is not None:
            if prev == C_CR and cls == C_LF:  # GB3
                join = True
            elif prev in _HARD or cls in _HARD:  # GB4, GB5
                join = False
            elif prev == L and cls in (L, V, LV, LVT):  # GB6
                join = True
            elif prev in (LV, V) and cls in (V, T):  # GB7
                join = True
            elif prev in (LVT, T) and cls == T:  # GB8
                join = True
            elif cls in (EXTEND, C_ZWJ, SPACING_MARK) or prev == PREPEND:  # GB9, GB9a, GB9b
                join = True
            elif emoji == 2 and pict:  # GB11
                join = True
            else:  # GB12/13: pairs of regional indicators; GB999
                join = prev == RI and cls == RI and ri_run % 2 == 1
            if not join:
                out.append(text[start:i])
                start = i
        if pict:
            emoji = 1
        elif not (emoji == 1 and cls == EXTEND):
            emoji = 2 if emoji == 1 and cls == C_ZWJ else 0
        ri_run = ri_run + 1 if cls == RI else 0
        prev = cls
    if text:
        out.append(text[start:])
    return out
