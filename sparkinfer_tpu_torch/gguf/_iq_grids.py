"""Codebook grids for the ggml importance-quantized (IQ) formats.

These constants are WIRE-FORMAT FACTS: each IQ format's bitstream stores
indices into a fixed codebook of lattice points (ggml's iq2xxs_grid /
iq2xs_grid / iq2s_grid / iq3xxs_grid / iq3s_grid / iq1s_grid tables,
ggml/src/ggml-common.h) — without the exact tables the formats cannot be
decoded. Stored here in a compact scheme of our own: each grid's entries
come from a tiny alphabet (e.g. {8, 25, 43} for IQ2, {-1, 0, 1} for IQ1),
so entries are kept as little-endian-packed alphabet indices (2-3 bits
each), zlib-compressed and base64-armored. `grid(name)` unpacks to the
(n_codes, width) int8 codebook, cached.
"""

from __future__ import annotations

import base64
import zlib
from functools import lru_cache

import numpy as np

# name -> (shape, alphabet, bits_per_entry, payload)
_PACKED: dict[str, tuple[tuple[int, int], list[int], int, str]] = {
    "iq2xxs": (
        (256, 8),
        [8, 25, 43],
        2,
        "eNoFwcFq4kAYAOB/hn9kzGlGosQ9jRIXt0/xJyQSexqLlWxPiSi4bzEJo3R7isVCe7PFQ/ct"
        "9/sAOAiQEICGEAxMYQ53kEAGFkqoYQcOWniBL2AMmWJDRsyzdwac8ylvOUNEhROMkTDFAits"
        "0GOHNwTBhRRGLMQf4cRZ9HuqRz3fu/VACillKOcykZm08kE+S+xTnwdhwBQqpSaKVKW86tSb"
        "Ai210VY/aafjQT6AUIYmnIXL0IXRcDuE0WjEIoxURFETwViMr+PVDzDcBCYztXGmNb8mxQSm"
        "fMpijFVM8SaGWTLbzbqfcm7ml3l2xwhJUUQTiomooA1V1JCnjiAxSZ245JiwVKVFukkPKWQy"
        "M5nLPrJBHuewYAUWqqAiL2BZLutlu8zvu3uw0mo7tsY6+2xxla5uq/NDt35dB49ss95Aqctx"
        "uSvpt3zCSlVUHSqoH+toW21hJ3ZqP9j7fXoAx13gEtc6bKKGGt0yj175oSdfeTgujpdj/0Sn"
        "6sSf8a9+wU51cUfdZzc6u3P+CpfpJbus3pp388Gv9nq89j/hK7rZb/z3HwV8b10=",
    ),
    "iq2xs": (
        (512, 8),
        [8, 25, 43],
        2,
        "eNoFwVFP6jwYAOC3TbsUrtqlmOlVIWCQX9EunRledWYQPFeTyBcPv6Ij00yu0KBRrybxmMmv"
        "/J4HAAMFBl0QIOEETkHBAEYwBgMWLmEKDq5hBgu4hTvwsIEHqOEZ9vABDSBEUIA6iKMQ9VCE"
        "zlAfDZFGMUpQijKUowLdoxJVaIcAY0wxwwJLrLDBFjs8wx5vMSKEBKRDOAlJj0SkT4ZEk5gk"
        "JCUZycmcFKQkFdkRoJhSyqigkipqqKWO3lJPUUACHpwHOoiDKgCGGWWMdZlgkik2YoZZ5tiC"
        "edawI0Md0uEd3Sk7Tx3oqu64+9ZtuogTHvAO5zzkPR7xPh9yzWOe8JRnPOcFX/OSV3zHQWBB"
        "BRNCSKGEEVY44cVevAkUkjAIeajDIgSJJZVMCimlkkZaOZVO3kkvUY/0eE/34ESeTE9QRCIe"
        "hZGO8ugxglN6+t9pdvZ7BgorqpjqKqGkUsooq5zyqlGoT/q8r/tpf9WHwWDgB+0ADcmQDy+G"
        "eggjM7oefYzQ+dn5zzmM2bg7VuPZuB4fxvcXuws2UZPNpJ5sJ0gTHeiO5jrUPR3pvh5qrWOd"
        "6FRf6UznutArXepK7zQYbKhhRhhplDHGGme8eTAHg2IS8ziML2Idg8WWWmaFlfbUKmustc56"
        "u7coIQlPholOPhO47F7aS3eJUpLyVKdJmqfLFKZiaqdu+ndKrsBhRx1zwkmn3NgZZ51z3qGM"
        "ZDzrZTqLM7i218drlJOc5/1c50Ve5l85zNjMz+pZf34//5rDQi7Mwi0+Fmc3+ia+efiDClLw"
        "Qhd5sSwei98CbofLq+XLEu5O7vhKr5LV9wrdr+9Hf4N1vl6uwWNPPfPCS6/8xBtvvfPeb3zr"
        "jx6VpAxKXuoyK29K2KiN32w2zabdoIpUvAqrXqWronqq4ME+/HuIHtePULN6VP+pfb2p2zp4"
        "Gmz9tt6+bdst2pEd3+ndfFft4HnwfPc8f3l6gT3d273bL/YXr7vXl1fzlr3/vE8/ep/FJzS4"
        "YU23Uc2kaZrs6+br5wsO+MAOk4M/NAf9/fq9+nn/6baqHbTjtmnblvxWv4+/4+Pk+Hw8Hv8H"
        "txDu+w==",
    ),
    "iq2s": (
        (1024, 8),
        [8, 25, 43],
        2,
        "eNoFwUFvokwDAOAZMkMGTzNkMLCnwWBj/RUzZCDY02CwsT1ho5vu/gow0FhP2GDjfidr3Ddd"
        "f+X3PABYAAMCBoABDoYgAAKMwBhMgAIapGAGDJiDBViCFViDn+AXqMAWtGAHDqAHZ/AX3ACE"
        "CNrQgRS60IM+DGEEJYxhAjOYwwI+widYwg18hTVsYAc/4BF+wSsElmVhi1jM4pawppaytJVa"
        "M8tYC6uyWmtv9dbFggghGzmIIhd5yEchitAdukcSxShBGXpAOSrQI3pCJXpBG1SjBr2hd9Sh"
        "IzqhL3RFAFsYY4IHmGGOhzjAAo/xBCuscYpn2OA5XuAlXuE1rvAWt3iHD7jHZwxtZNu2Y1Pb"
        "s6Wd2Jmd24Vd2rXd2J0NiEUwIYQRToYkIIKMyZQooklKZsSQOVmQJVmRNalIS3pyI9BBDnVc"
        "x3N8J3SkkziZkzuFUzq10zlgwAZ8MBpMBtOBGfwZQIqoTR1KqUs96tOQRvSOShrThGY0pwV9"
        "pE+0pC90Q19pTRv6Rjt6pCf6Ra8UMIthRtiAMcbZkAVMsBEbswlTTLOUzZhhc7ZgS7Zia1ax"
        "LWvZjh1Yz6CLXMelrueGbuRKN3Fzt3Brt3E7F3CLY04445wPecAFH/MJV1zzlM+44XO+4Eu+"
        "4mte8S1v+Y4feM/PHHrIsz3Ho57reZ7vhV7kSS/2Ei/zcq/wSq/2Gq/zwBAPyZAN+VAM1VAP"
        "zbAa3obQR77tOz71Pd/3Q1/6sZ/4mZ/7hV/6td/4ILACHJCABTwQgQp0YIJfwSVAP+gP+ePx"
        "BxCWwIIIJrgYikAIMRZToYQWRszFQqxFJfaiFzcBQxTS0A29MAxlGIdJmIdFWIZ12IRdCEaD"
        "0Wg0GU1HemRGu9F+9D2CEYrsyIlo5EV+FEZRJKM4SqIsyqMiKqM6aqIuAmM8JmM25mMxVmM9"
        "NuOf42oM79AdvZN3T3dggidswidqoidmsp/cJvAe3dP74/1gOpqup7vpfgolkrZ0JJWu9KQv"
        "f8hQRvJOShnLRGbyQeaykI/ySZbyRW5kLRvZyaM8yS95lUBZCiuimOJqqAIl1EiNlVJapWqm"
        "jJqrhVqqlVqrSm1Vq3bqoHp1VjBGMY3d2Iv9OIplnMRZnMdFXMZ13MRAWxprogeaaa6HOtBC"
        "j/RYT7TSWqd6po2e64Ve6pVe60pvdat3+qB7fdYwQYmdOAlN3MRL/CRMokQmcZIkWZInRVIm"
        "v5M6aZIuAamV4pSkLOWpSFWqU5NW6d8UZihzMpq5mZf5WZhFmcziLMmyLM+KrMyarMvAzJrh"
        "GZmxGZ+JmZrpmZlVs88ZfEAP9EE+AGMZbIhhhpuhCYwwIzM2E6OMNqmZGWPmZmGWZmXWpjJb"
        "05qdOZjewBzldu7kNHdzL/fzMI9ymcd5kmd5nhd5mdd5k3c5mOM5mbM5n4u5muu5mf+aV3NY"
        "oMIunIIWbuEVfhEWUSGLuEiKrMiLoiiLumiKrgALa4EXZMEWfCEWaqEXZlEt4CN6pI93j/IR"
        "LK0lXpIlW/KlWKqlXprl87Jawif0RJ/kE3gOntvn72dYotIuaemWXumXYRmVskzKrMzLoizL"
        "puxKsLJWeEVWbMVXYqVWemVW1erPCr3QF/ny+PL1AtZ4TdZszddirdZ6bdbVGm7Qhm7k5mHz"
        "uvnYgJ/9T/iKXunr5vX0Cn5Nf8W/v36DyqpwRSpW8SqoRDWuVKUrU82rRbWsVlVVtdWh6itY"
        "o9qpae3WXu3XYR3Vso7rpM7qvC7qum7qrv5Xgy3eDrZsy7dqq7dmCxvU2I3T0MZtvMZvwkY2"
        "cZM0WZM3RVM2ddM0XQNaq8UtaVnLW9GqVremrdp9C9/QG327f5NvYId3bMd3aqd3ZnfZwXf0"
        "Lt8376P9cv+83+4ve9ihzulo53Ze53dRJ7u4S7qsy7uiK7u6a7quAwd8YAd+UAd9MIfnA/xA"
        "H/RDfvz3AXqrxz3pWc970ate96av+s8eHtGRHuXxdPw6gs/0c/0JT+hET3cnefp3An9mf+Z/"
        "uv+BMz4Pzvw8Ok/P6qzP5nw5387ya/NlXQaX0WVymV62l91lf/m+wCu60qu8vl+vV/A3+Jv/"
        "N/iefF++i39v/8htcBO30W1y291ut/8Dvmbuvw==",
    ),
    "iq3xxs": (
        (256, 4),
        [4, 12, 20, 28, 36, 44, 52, 62],
        3,
        "eNoBgAF//gAgAASQAAvwABAgARkgAjvQA0EwBEigBFFQBVigBWHABngACIJACIkACZKQCZvw"
        "CanwCr0QDMeADMpQDfiwEB9BEi+xEz0RFEehFWrRGbSBHMzhHOMRHwEyIAiiIBEyIRiiIRxy"
        "IigCJEKSJFAiJYEyKIiiKJGCKboCLMICLdliLvYSMAWDMlBDNWaTN4UjPeADQAKUQAsEQRJk"
        "QRkkQkE0REWEREoURVg0R3eER4AkSIn0SJAkSZ8ESq0UTMjETPjETx21UkN1VWHFV8E1XM5V"
        "XgGGYAoWYROGYjWmY0AmZFCWZWRmZoE2aIhWaaqma8m2bRh3cjoHdEYndW3HeJ43e9sHfwT4"
        "gB34gSv4gnwIiZ8IirBoi8dYjgSZkjRZlWOJl8WJnMqJnQoaojgKpEZqpW3KqJqqq8K6rgg7"
        "sRers0KbtahLveJLwSRswjQcxXH8yLSMzd5M0kWt1ps93NE94AV+4Aiu4Spu5WCu6KWu6sDe"
        "7NsO7xEf8kAv9FSP+dhamTg=",
    ),
    "iq3s": (
        (512, 4),
        [1, 3, 5, 7, 9, 11, 13, 15],
        3,
        "eNoBAAP//AAQAAJQAAeAAAmgAAzgABAQARWwASAgAiVwAimwAjAgAznAAz8ABEEgBESABEnQ"
        "BFAwBVeQBV1ABnFQB3oACIFQCIeACIvgCJFQCZjACaJQCqeQCquAC7swDMnQDNAgDdmwDd5A"
        "DuigDveQD/0AEAvxEBFBERoBEiOREjghFEQBFVJhFVsRFmVxFnaxF4aRGIuRGaqRG8AhHMQB"
        "HdJhHduBHuwBIAEiIASCIAmyIA3yIBAiIRnCIR7CIi4SIzoCJEEyJEaCJEwSJViyJWGCJmqC"
        "J34CKIrSKI8CKZSiKaAyKq0CK7oSLMRyLMiyLNFyLdjCLeEiL/gyMAWjMAyTMRsjMiaDMiwT"
        "NEizNFGDNVqTNpBDOZdDOqYTPMODPMoTPd0TPvKDPwAUQANUQAeEQArEQA4UQRN0QRikQSE0"
        "QiWEQip0Qzi0Qz0EREKEREv0RFJURVnERWKURoFESIcUSZOESZ8USqv0SrnES8AkTMWUTNJE"
        "Tdm0TeKETvYUUAcFUROlUR0VUjrVU0SVVFL1VWC1VngFWIJ1WJHVWrFVXMllXdg1XuglYAm2"
        "YA32YBKWYRvWYSJGYieWYjOWY0E2ZEXGZFE2ZWAGZ3rmZ4CmaJCmaZyGasGGbMwWbdN2bdgW"
        "buN2bu22bwOXcA4ncRmncjBHc0GHdEpXdVpHdm63d44XesE3fNAnfd0HgASogBBIgReogSGI"
        "gjgohEeYhEsohVjYhWOYhm0YiIOIiI0YiZsIiq8oi7hIjMm4jNAojdnYjQApkBT5kSCZk0V5"
        "lFEpl4vJmbCJnM2JneOZngKKoAwqoSBKoieqojbKo0E6pEWqpFGqpXoKqIk6qZjqqasqrMeK"
        "rNdKrular/sasAQLsRprskprtWm7tqIrvMQrvQm8wA2cwRsMw0AMxVdMx4rMyaLcyrKMy8DM"
        "zNEMzhU90jIN1EPN1XBd2KCd3MsN4AR+4BAu4R4O4iwu40Ke5FQ+5mUe6ISO6I4e6Zie6sKu"
        "7d2+7gFf8AsP8Sgv9WIv+JkP/JboMuw=",
    ),
    "iq1": (
        (2048, 8),
        [-1, 0, 1],
        2,
        "eNoNl0HKslAAAEsyylWGSrayyKhOkR8q2convoe6ylDJTlGRYa4yfJKtLDKqU/7/CWYzMEyt"
        "RtTIWqtG1egaWxNqw9qkNqspNVAza6jm13a1Qy2uJTVcK2vP2qf2qzXqZJ2uM3Wuztf7dbEu"
        "1dW6VjfqsO7U3bpXD+qbelRP61k9r1f1GkEQLYIiWEIghsSEmBEKAQib8IiQ2BEHIiYSIiUw"
        "URAl8SQ+xI+gG0yDa4gNqaE1YMNpeA2/kTaKRvUf3CBJskmyZI/sk1NyTirkktRJQJokJBFp"
        "kytyTfrkhtySezIlMXkj7+SDfJEV+Sa/JNPkm1JTbupNowmbVnPVdJtBM2xGzbSZNYtmrUW0"
        "Wi2qxbaE1rA1ac1aSgu0UMtv7VqHVtxKWrhVtp6tT+vXItt0m2nz7VFbbEttvQ3asO22vXbY"
        "TttZO28X7apdowiqRVEUSwnUkJpQM0qhAGVTLuVTO+pARVRMJRSmSupJfagf1enQHabDd0Yd"
        "sSN15I7egR2r43a8jt8JO2kn6+SdR6fq1OkG3aTbdIfu0izdowf0iJ7SCr2kdRrQBm3SkEa0"
        "Ta9onz7SVxrTD/pF012my3XF7ryrdrWu0YVdq+t0vW7QjbppN+vm3apbZ5pMm2EYlukxPDNg"
        "xozEKIzKLJglAxiTgQxibGbN+MyGOTJn5sJkDGZuTMHcmQfzYirmyxAsyVIszTIsy3Iszwrs"
        "kBXZCTtjJVZmFVZlAWuwJgtZxNqsw7qsx/pswIbsjj2wRzZiYzZhL2zKZixmc7Zg72zJPtmK"
        "rXMNjuSaHMtxXI/rcwNuzM25P07mFG7BLTnAQQ5xFmdzLudxPrfhQm7LnbiEu3KYe3Ffju5x"
        "PbEn9eSe2tN6eg/2rJ7TW/XcntcLemEv6qW9rFf1OnyXZ/k+P+BF/o+XeYVf8IA3ecgj3uYd"
        "fsX7/JY/8yl/5TF/4x/8m//y7T7XH/XHfbmv9rW+3jf6sG/13X7QD/tRP+3n/Xu/JhBCS6AE"
        "VhCEoSAKE2EmKAIQbMEVfGEnHIRYSAQslMJTqISP8BPIAT1gBvxAHPwN5IE2gANr4AzcgTfw"
        "B8EgGlwG+aAYVIP6sDWkhvSQHQrD4XAynA2VIRiioT30h/thPEyG6RAPy+Fz+Bn+huSIGXEj"
        "fiSO5JEyUkfayBjBkTVyRsEoGqWjbFSMHqPqv96sOBCn4lxUxIUIRFOEoi2uRV/ciGfxImYi"
        "Fm/iXXyIL/EtfkVy3Bl3x/xYHEtjbQzHq7E7DsfH8Wl8Gd/HtQkxaU2oCTsRJsPJZDKbKBMw"
        "MSf+ZDc5TOJJMiknz8ln8pu0p/SUmfJTcapOtakxhVN36k2DaTiNppdpPi2mr2k1rc2IWWtG"
        "zYTZcDaZzWbKDMzQzJ75s93sMItnyQzPytlz9pn9ZuScnnNzca7NjTmcW3Nn7s69eTDP5sX8"
        "MX/Pa1JdakhNqS11JVbipJ7UlwbSWJpKirSQlhKQTAlKSLIlR/KljbSV9tJROkkX6SphqZQe"
        "0lMi/+g/5o/7E/+kP+MP/jl/3l/4d/7L/qq/uszKvDyVFXkhL2UgmzKUkezKa9mXN/JW3ssn"
        "+Sxf5KuM5VJ+yF+5rhAKqVAKrTAKq3AKrwiKqMwUSZEVRVEVTdEVoJgKVJBiKbbiKp7iK4ES"
        "KgflqERKrKRKpmAlVwrlrlTKR/kpdZVU2yqjsmpP7asDdaRO1bn6pyrqQtVVoBoqVJFqq2vV"
        "VzfqXo3URM1UrD7Ul/pWyQW9YBf9hbj4W2gLfQEX1sJdeItgES6iRbrIFvmiWFSLukZqTY3S"
        "OhqjsVpPG2gjbazNNUVbakAzNFODGtJsbaWtNV8LtK120s7aVcNart20h/bS3tpX45byUl1q"
        "S7i0ls7SW4bLbFkt63pDJ/Wm3ta7Oqv39YE+0qf6XFf0hQ50U4c60m3d1zf6ST/rWL/ppf7Q"
        "3/r3fyhaoA0oQAMGsIADPcADAYhgDCZgBiQgAwWoQAM6AMAAJoAAAQvYwAEu8IAPAhCCA4hA"
        "CjKAQQ4KUIIK/EDdaBpdgzX6xsAYGX+GYiwNYJgGNJBhG2vDNyLjYlwNbBTG3XgZDZM0aZMx"
        "WZMzeyZvDkzRnJgzUzJlUzFVUzOXpm4C0zShiUzLtE3HdM216Zm+GZihuTNjMzFTMzOxmZuF"
        "+TBfZmX+zDokYAOSsAnbsANp2IUMZCEHediHAziCIhzDKZxDCf5BGSpQhQuoQR0CaEATQoig"
        "BW3owBV0oQd9GMANDOEW7uERRvAME3iBKcwghjm8wQI+4AtW8A2/sIbqiEAN1EQt1EY0YhCL"
        "eohHAhqgIRohEY3RBE2RhBSkogXS0BLpCCADmQgihCxkIwe5yEM+CtEBReiEYnRGCUoRRnf0"
        "RBV6ow/6ooZFWk2rbXUs1upZA2tmKdbCWlrAMi1oIcuybGtlrS3P8q2DdbYu1tXC1s16WF+r"
        "bhM2aVM2bTM2a3M2b4u2ZMu2Yqu2Zus2sA3btKGNbMu2bcd2bc/27cAO7b0d2Wc7tTMb27l9"
        "swu7shtOy2GdviM4ojN2po7iLBzNAQ50kGM5trN2fGfjbJ29kzhXBzu5c3PuzsMhV8yKW/Er"
        "cSWv9BVcoZW1clbuylsFq3C1X+WralV3G27Tbbtdl3UH7tAdu1NXcTUXuNBFru36buBu3aOb"
        "uFcXuw/37X5des2t+fV8La3VNVyjtbVeraN1us7X1Zr2uh7rcV7fG3hjb+rNvT9P8Rbe0gOe"
        "6UEPebbneCtv7fne0Yu8s3fxrl7mYS/3bt7de3gv7+uRfsunfNpnfc7nfdlXfNXXfN0HvulD"
        "H/m27/qe7/uBH/on/+wnfupjP/cL/+4//cp/+x+fCNoBGwjBOJgE02AeKMEiWAYgMAMYoMAK"
        "nGAV+MEm2AWHIAqSIAvy4BYUQRm8gnfwC7gNvxE30sbYwI2zcTfhJtqkm9vmvamHjbATsuEg"
        "HIXjcBrOQylUQjVchCA0Qxii0A5XoR9uw0N4DJMQh4/wFVbhN6S33La3lbbyVtvqW7i1ts7W"
        "2/rbcHvaZtvb9r59b2s7YtfaUTthN9xNdrOdstN3YGfu0M7e+bvd7rCLd8kO78rdc/fZ/Xbk"
        "nt4ze27P78W9tJf32l7fG3u4R3trb++9fbAP99H+vM/2+b7YV/vagTi0DtSBPQiH4WFymB3A"
        "wTzYB/+wOxwO8SE54EN5eB4+h9+BOfJH6SgfwREenaN79I7hMTsWx3rUjroRG/WjcTSN5pEU"
        "KdEiApEZwQhFduREfhREm2gb7aNjdIrO0SW6Rji6Re+IPnEn/iSepJN80k7Lk36CJ/vknNxT"
        "cNqeolN6up9ep1pMxK2YitlYiIfxJJ7FUqzEIDZjO/bjMN7FhziOkxjHZfyMP/EvJs/NM31m"
        "ztxZPEtn+ayetbN+Ns7w7Jzds3eOzvm5OFfnWkIkrYRK2ERIhskkmSVKAhIzQckuOSRxkiQ4"
        "KZNn8kl+CXmhL9yld+Ev4kW6qBftAi/WxbmEl+0luqSX7JJfikt1qaeNtJm2007Kpr20nw7S"
        "UTpOp+k8VVI9BamZwhSldrpO/fSYntJritNb+khf6Tv9puSVvjJX/ipe5at61a761bjCq3UN"
        "ruE1umbX/Pq91rNG1sw6GZv1snE2z5YZyMwMZiizMjtbZW62zvzsmJ2ya5ZlOLtlj+yb1TCJ"
        "W5jCHUxjBrOYwzweYBFP8QxLWMYKVrGGdQywgU0MMcIWtrGDXexhHwc4xHsc4Rin+IozjHGO"
        "C3zHJX7iCn/wD9fzRt7J2ZzPhXycT3MlX+RaDnIjhznK7dzPN/khP+bnPMmveZbj/JW/829O"
        "3rgbfxNv0k296TfjBm/o5ty8m3+LbuktvxW36tYomkW76BTdgi16Rb8QikExKsbFvPgrlGJR"
        "LAtQmAUsUGEX68IvgmJb7ItjcSmuBS7uxaN4F+SdvYt3+a7etbt+h3fr7t6je3rP7vie32sl"
        "UbZKqmRLoRyWk3JWKiUozRKVdrkrD2VcJiUuy/JZfspfST7aD/rBPLgH/+g/1If2AA/4sB7O"
        "w314j+hxeVwf+aN4EM/Wk3p2nvxz+Jw8Z0/lCZ7oaT/95+55eMbP5Imf5fP5/Dx/T/4lvqSX"
        "/NJf5gu+rJfzcl/+K3htXuErejWrdtWpuhVb9apxNa3+KqUClVnBClV25Vfbal8dq6g6Vefq"
        "WuHq9n8+6Tf37r8Hb/Etv9X38m284Ru9rffqvX6f3pc3fufv4v14v97vd+1DfFof6iN8hp/J"
        "Z/YBH/ODPvZn9zl84k/ywZ/y8/x8Pr8P+WW+/HfwFb/SV//Cr/N1v8E3/F6++bf2I36tH/UT"
        "fsPf5Df7gZ/5Q7/d7/CLf8kP/8rf8/f5/X7/AK17TfE=",
    ),
}


@lru_cache(maxsize=None)
def grid(name: str) -> np.ndarray:
    """Unpack one codebook to its (n_codes, width) int8 array."""
    shape, alphabet, bits, payload = _PACKED[name]
    raw = np.frombuffer(zlib.decompress(base64.b64decode(payload)), np.uint8)
    n = shape[0] * shape[1]
    b = np.unpackbits(raw, bitorder="little")[: n * bits].reshape(n, bits)
    idx = np.zeros(n, np.uint8)
    for k in range(bits):
        idx |= b[:, k] << k
    return np.asarray(alphabet, np.int8)[idx].reshape(shape)
