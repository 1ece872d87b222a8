"""Per-tenant page budgets for the serve/ daemon.

Two halves, both riding machinery that already exists:

* **enforcement** — a session's MapReduce objects are created with
  ``memsize``/``maxpage``/``outofcore`` defaults derived from the
  tenant's page allowance (``MRTPU_TENANT_PAGES``), so a dataset that
  outgrows the budget spills through ``core/dataset.py``'s page
  splitter into the session's own scratch directory.  The budget keys
  are PINNED on the session's ObjectManager (``pin``): the script's own
  ``set maxpage ...`` raises instead of lifting the allowance.  Budgets
  are per-MR settings, so one tenant exhausting its allowance can only
  ever spill its OWN frames — another tenant's resident pages are
  untouched by construction.
* **attribution** — a :class:`~..core.runtime.PageAccount` per tenant,
  installed as a thread scope around each session run, receives every
  byte charged through ``Counters.mem`` and feeds the
  ``mrtpu_tenant_pages{tenant}`` gauge plus the ``/v1/stats`` tenants
  section.

``MRTPU_TENANT_PAGES=0`` (the default) disables enforcement — sessions
run with the server's plain defaults and the accounts only attribute.
The pages are frame bytes (``Counters.mem``), not the CUDA caching
allocator's reserve.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..core.runtime import PageAccount
from ..utils.env import env_knob


class TenantBudgets:
    """tenant name → :class:`PageAccount` registry + the MR settings
    defaults a session's ObjectManager starts from."""

    def __init__(self, pages: Optional[int] = None,
                 memsize: Optional[int] = None):
        self.pages = pages if pages is not None \
            else env_knob("MRTPU_TENANT_PAGES", int, 0)
        self.memsize = memsize if memsize is not None \
            else env_knob("MRTPU_MEMSIZE", int, 64)
        self._accounts: Dict[str, PageAccount] = {}
        self._lock = threading.Lock()

    def account(self, tenant: str) -> PageAccount:
        with self._lock:
            acct = self._accounts.get(tenant)
            if acct is None:
                acct = self._accounts[tenant] = PageAccount(
                    tenant, self.memsize * (1 << 20), self.pages)
            return acct

    def defaults_for(self, tenant: str, scratch: str) -> dict:
        """The ObjectManager ``set`` defaults a session starts from:
        spill always lands in the SESSION's scratch dir (never the
        daemon cwd), and a page allowance arms the core/ budget."""
        d: dict = {"fpath": scratch}
        if self.pages > 0:
            d.update(memsize=self.memsize, maxpage=self.pages,
                     outofcore=1)
        return d

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            accounts = dict(self._accounts)
        return {t: a.snapshot() for t, a in sorted(accounts.items())}
