"""SIP registration agent with digest auth and periodic refresh.

Capability parity with the reference's account registration
(``SIP/InfernSIP.py:82-92`` using sippy's ``SipRegistrationAgent``): register
each configured profile at startup, re-register before expiry, surface
success/failure to a callback.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional, Tuple

from ..utils.logging import get_logger
from .message import NameAddr, SipURI
from .stack import SIPStack, digest_response

log = get_logger("sip.reg")


class RegistrationAgent:
    def __init__(self, stack: SIPStack, server: Tuple[str, int], aor_user: str,
                 username: str = "", password: str = "", expires: int = 300,
                 on_result: Optional[Callable[[bool, str], None]] = None):
        self.stack = stack
        self.server = server
        self.aor_user = aor_user
        self.username = username or aor_user
        self.password = password
        self.expires = expires
        self.on_result = on_result
        self._task: Optional[asyncio.Task] = None
        self._cseq = 0
        self.registered = False

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()

    async def register_once(self) -> bool:
        ruri = SipURI(host=self.server[0], port=self.server[1])
        aor = NameAddr(SipURI(user=self.aor_user, host=self.server[0]))
        self._cseq += 1
        msg = self.stack.make_request("REGISTER", ruri, aor, aor,
                                      cseq=self._cseq)
        msg.set("expires", str(self.expires))
        try:
            final = await self.stack.send_request(msg, self.server, timeout=8.0)
        except TimeoutError:
            self._report(False, "timeout")
            return False
        if final.code in (401, 407) and self.password:
            chal = final.get("www-authenticate") or final.get("proxy-authenticate")
            hdr = "authorization" if final.code == 401 else "proxy-authorization"
            self._cseq += 1
            msg2 = self.stack.make_request("REGISTER", ruri, aor, aor,
                                           call_id=msg.call_id, cseq=self._cseq)
            msg2.set("expires", str(self.expires))
            msg2.set(hdr, digest_response(chal, "REGISTER", str(ruri),
                                          self.username, self.password))
            try:
                final = await self.stack.send_request(msg2, self.server, timeout=8.0)
            except TimeoutError:
                self._report(False, "timeout")
                return False
        ok = final.code == 200
        self._report(ok, f"{final.code} {final.reason}")
        self.registered = ok
        return ok

    async def _loop(self) -> None:
        while True:
            ok = await self.register_once()
            # refresh at 80% of expiry on success; back off 30 s on failure
            await asyncio.sleep(self.expires * 0.8 if ok else 30.0)

    def _report(self, ok: bool, detail: str) -> None:
        (log.info if ok else log.warning)("REGISTER %s@%s: %s",
                                          self.aor_user, self.server, detail)
        if self.on_result:
            self.on_result(ok, detail)
