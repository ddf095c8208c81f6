// Native star-topology TCP transport for the async parameter-server control
// plane (M2 messaging contract, SURVEY.md §2.3).
//
// This is the framework's analog of the reference's out-of-tree native
// communication muscle: the reference reaches C++ through torch.distributed's
// gloo backend (example/main.py:165; SURVEY.md §2.2 "the native-equivalence
// obligation attaches to L0"). Here the TPU data plane rides compiled XLA
// collectives (parallel/sync.py); this library is the *host-side* control
// plane — framed tagged-tensor messages between controller processes — done
// natively so push/pull traffic never serializes through the Python
// interpreter (no GIL on the receive path, zero-copy frame assembly).
//
// Wire format (interoperable with utils/messaging.py TCPTransport):
//   little-endian header { int32 sender; int32 code; int64 nbytes; }
//   followed by nbytes of float32 payload.
// Topology: rank 0 binds and accepts world_size-1 workers; each worker dials
// in and identifies itself with a hello frame (code=ParameterRequest, empty
// payload). Reader threads pump incoming frames into a condvar-guarded inbox.
//
// C API (ctypes-friendly, see native/__init__.py):
//   tpt_create / tpt_send / tpt_recv / tpt_msg_* / tpt_close / tpt_free

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <errno.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

#pragma pack(push, 1)
struct Header {
  int32_t sender;
  int32_t code;
  int64_t nbytes;
};
#pragma pack(pop)
static_assert(sizeof(Header) == 16, "wire header must match Python struct '<iiq'");

std::mutex g_error_mu;
std::string g_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lk(g_error_mu);
  g_error = msg;
}

bool send_all(int fd, const char* buf, size_t n) {
  while (n > 0) {
    ssize_t w = ::send(fd, buf, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    buf += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, char* buf, size_t n) {
  while (n > 0) {
    ssize_t r = ::recv(fd, buf, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    buf += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

}  // namespace

extern "C" {

struct TptMsg {
  int32_t sender;
  int32_t code;
  int64_t nfloats;
  float* data;  // owned; freed by tpt_msg_free
};

struct TptTransport {
  int rank = -1;
  int world = 0;
  int listen_fd = -1;
  // peers_mu guards peer_fds / send_mu / readers: the elastic accept thread
  // mutates them concurrently with sends and shutdown. Lock order where both
  // are needed: per-peer send mutex BEFORE peers_mu (see tpt_send /
  // admit_worker).
  std::mutex peers_mu;
  std::map<int, int> peer_fds;                            // rank -> socket
  std::map<int, std::unique_ptr<std::mutex>> send_mu;     // per-socket write lock
  std::vector<int> retired_fds;  // replaced-on-rejoin sockets, closed at teardown
  std::vector<std::thread> readers;
  std::thread acceptor;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<TptMsg*> inbox;
  std::atomic<bool> closed{false};

  void push(TptMsg* m) {
    {
      std::lock_guard<std::mutex> lk(mu);
      inbox.push_back(m);
    }
    cv.notify_one();
  }

  void reader_loop(int fd) {
    for (;;) {
      Header h;
      if (!recv_all(fd, reinterpret_cast<char*>(&h), sizeof(h))) break;
      if (h.nbytes < 0 || h.nbytes % 4 != 0) break;  // malformed frame
      const int64_t nfloats = h.nbytes / 4;
      float* data = nullptr;
      if (h.nbytes > 0) {
        data = static_cast<float*>(malloc(static_cast<size_t>(h.nbytes)));
        if (data == nullptr) break;
        if (!recv_all(fd, reinterpret_cast<char*>(data), static_cast<size_t>(h.nbytes))) {
          free(data);
          break;
        }
      }
      push(new TptMsg{h.sender, h.code, nfloats, data});
    }
    cv.notify_all();  // wake blocked recv so it can observe a dead peer/close
  }

  // Handshake one inbound worker connection; a duplicate rank is a REJOIN
  // (restarted worker): the stale socket is shut down — its reader exits —
  // and replaced. Returns false (closing conn) on a malformed hello.
  bool admit_worker(int conn) {
    int one = 1;
    setsockopt(conn, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    // bound the handshake: a half-open connection (port scan, worker dead
    // right after connect) must not wedge the single-threaded acceptor or
    // hang shutdown_all's join forever
    timeval hs_to{5, 0};
    setsockopt(conn, SOL_SOCKET, SO_RCVTIMEO, &hs_to, sizeof(hs_to));
    Header hello;
    if (!recv_all(conn, reinterpret_cast<char*>(&hello), sizeof(hello)) ||
        hello.nbytes != 0 || hello.sender < 1 || hello.sender >= world) {
      set_error("worker handshake failed or invalid rank");
      ::close(conn);
      return false;
    }
    timeval no_to{0, 0};  // handshake done: reads must block indefinitely
    setsockopt(conn, SOL_SOCKET, SO_RCVTIMEO, &no_to, sizeof(no_to));
    std::mutex* m = nullptr;
    {
      std::lock_guard<std::mutex> lk(peers_mu);
      auto it = send_mu.find(hello.sender);
      if (it == send_mu.end()) {
        send_mu[hello.sender] = std::make_unique<std::mutex>();
      }
      m = send_mu[hello.sender].get();
    }
    {
      // hold the peer's send mutex across the swap so an in-flight send to
      // the dead socket finishes (or fails) before the fd changes under it
      std::lock_guard<std::mutex> slk(*m);
      std::lock_guard<std::mutex> lk(peers_mu);
      if (closed.load()) {
        // raced shutdown_all: registering now would spawn a reader whose
        // socket the teardown sweep already missed — bail instead
        ::close(conn);
        return false;
      }
      auto it = peer_fds.find(hello.sender);
      if (it != peer_fds.end()) {
        // shutdown only — closing here could recycle the fd number while
        // the old reader is still inside recv on it; the fd is closed at
        // teardown instead (bounded by the number of rejoins)
        ::shutdown(it->second, SHUT_RDWR);
        retired_fds.push_back(it->second);
      }
      peer_fds[hello.sender] = conn;
      readers.emplace_back([this, conn] { reader_loop(conn); });
    }
    return true;
  }

  // Elastic accept loop: runs after the initial rendezvous so restarted
  // workers can reconnect mid-run (the reference has no rejoin logic,
  // rendezvous is once-and-static). Polls with a timeout rather than
  // blocking in accept(): shutdown() on a listening socket does NOT wake a
  // blocked accept on Linux, so a blocking loop would deadlock
  // shutdown_all's join.
  void accept_loop() {
    for (;;) {
      if (closed.load()) return;
      pollfd p{listen_fd, POLLIN, 0};
      int r = ::poll(&p, 1, 200);
      if (closed.load()) return;
      if (r <= 0) continue;
      int conn = ::accept(listen_fd, nullptr, nullptr);
      if (conn < 0) {
        if (closed.load()) return;
        continue;
      }
      admit_worker(conn);
    }
  }

  // Idempotent teardown: wake waiters, unblock readers, join, close fds.
  // Used by tpt_close, the destructor, and tpt_create's error paths (where
  // reader threads may already be running — destroying a joinable
  // std::thread would call std::terminate).
  void shutdown_all() {
    if (!closed.exchange(true)) {
      std::lock_guard<std::mutex> lk(peers_mu);
      for (auto& kv : peer_fds) ::shutdown(kv.second, SHUT_RDWR);
      if (listen_fd >= 0) ::shutdown(listen_fd, SHUT_RDWR);
    }
    // Lock-then-notify so a receiver that checked the predicate before
    // `closed` flipped is inside cv.wait (mu released) when the notify
    // fires — otherwise the wakeup is lost and recv blocks forever.
    { std::lock_guard<std::mutex> lk(mu); }
    cv.notify_all();
    // join the acceptor first: once it is gone, nothing mutates `readers`
    if (acceptor.joinable()) acceptor.join();
    std::vector<std::thread> to_join;
    {
      std::lock_guard<std::mutex> lk(peers_mu);
      to_join.swap(readers);
    }
    for (auto& th : to_join) {
      if (th.joinable()) th.join();
    }
    std::lock_guard<std::mutex> lk(peers_mu);
    for (auto& kv : peer_fds) ::close(kv.second);
    peer_fds.clear();
    for (int fd : retired_fds) ::close(fd);
    retired_fds.clear();
    if (listen_fd >= 0) {
      ::close(listen_fd);
      listen_fd = -1;
    }
  }

  ~TptTransport() {
    shutdown_all();
    for (TptMsg* m : inbox) {
      free(m->data);
      delete m;
    }
  }
};

const char* tpt_last_error() {
  // Copy into a thread-local buffer under the lock: returning g_error.c_str()
  // directly would race a concurrent set_error reallocating the string while
  // the caller copies it.
  thread_local std::string local;
  std::lock_guard<std::mutex> lk(g_error_mu);
  local = g_error;
  return local.c_str();
}

// Create a transport endpoint. Rank 0 binds master:port and accepts
// world-1 workers; other ranks dial in, retrying refused connections until
// timeout_s elapses (rendezvous blocks until all ranks join, the reference's
// init_process_group semantics, example/main.py:165). Returns NULL on error.
void* tpt_create(int rank, int world, const char* master, int port, double timeout_s) {
  auto t = std::make_unique<TptTransport>();
  t->rank = rank;
  t->world = world;

  if (rank == 0) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
      set_error("socket() failed: " + std::string(strerror(errno)));
      return nullptr;
    }
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
        ::listen(fd, world) < 0) {
      set_error("bind/listen failed: " + std::string(strerror(errno)));
      ::close(fd);
      return nullptr;
    }
    t->listen_fd = fd;
    // initial rendezvous: block until world-1 DISTINCT workers are admitted
    // (a duplicate --rank counts as a rejoin and replaces its predecessor)
    for (;;) {
      {
        std::lock_guard<std::mutex> lk(t->peers_mu);
        if (static_cast<int>(t->peer_fds.size()) >= world - 1) break;
      }
      int conn = ::accept(fd, nullptr, nullptr);
      if (conn < 0) {
        set_error("accept failed: " + std::string(strerror(errno)));
        return nullptr;
      }
      t->admit_worker(conn);
    }
    // elastic phase: keep accepting so restarted workers can rejoin mid-run
    TptTransport* tp = t.get();
    t->acceptor = std::thread([tp] { tp->accept_loop(); });
  } else {
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    char portbuf[16];
    snprintf(portbuf, sizeof(portbuf), "%d", port);
    if (getaddrinfo(master, portbuf, &hints, &res) != 0 || res == nullptr) {
      set_error("getaddrinfo failed for master host");
      return nullptr;
    }
    const auto deadline =
        std::chrono::steady_clock::now() + std::chrono::duration<double>(timeout_s);
    int fd = -1;
    for (;;) {
      fd = ::socket(AF_INET, SOCK_STREAM, 0);
      if (fd >= 0 && ::connect(fd, res->ai_addr, res->ai_addrlen) == 0) break;
      if (fd >= 0) ::close(fd);
      fd = -1;
      if (std::chrono::steady_clock::now() >= deadline) {
        freeaddrinfo(res);
        set_error("connect to master timed out");
        return nullptr;
      }
      std::this_thread::sleep_for(std::chrono::milliseconds(200));
    }
    freeaddrinfo(res);
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    Header hello{rank, /*code=ParameterRequest*/ 1, 0};
    if (!send_all(fd, reinterpret_cast<const char*>(&hello), sizeof(hello))) {
      set_error("hello frame send failed");
      ::close(fd);
      return nullptr;
    }
    t->peer_fds[0] = fd;
    t->send_mu[0] = std::make_unique<std::mutex>();
    TptTransport* tp = t.get();
    t->readers.emplace_back([tp, fd] { tp->reader_loop(fd); });
  }
  return t.release();
}

int tpt_rank(void* handle) { return static_cast<TptTransport*>(handle)->rank; }

// Send n float32s to dst. Returns 0 on success, -1 on error.
// Lock order: the per-peer send mutex is taken BEFORE re-reading the fd
// under peers_mu, matching admit_worker's swap (which holds the send mutex)
// so a rejoin can never change the fd mid-frame.
int tpt_send(void* handle, int dst, int code, const float* data, int64_t n) {
  auto* t = static_cast<TptTransport*>(handle);
  std::mutex* m = nullptr;
  {
    std::lock_guard<std::mutex> lk(t->peers_mu);
    auto it = t->send_mu.find(dst);
    if (it == t->send_mu.end()) {
      set_error("no connection to rank " + std::to_string(dst));
      return -1;
    }
    m = it->second.get();  // stable: entries are never erased
  }
  std::lock_guard<std::mutex> slk(*m);
  int fd = -1;
  {
    std::lock_guard<std::mutex> lk(t->peers_mu);
    auto it = t->peer_fds.find(dst);
    if (it == t->peer_fds.end()) {
      set_error("no connection to rank " + std::to_string(dst));
      return -1;
    }
    fd = it->second;
  }
  Header h{t->rank, code, n * 4};
  if (!send_all(fd, reinterpret_cast<const char*>(&h), sizeof(h)) ||
      (n > 0 && !send_all(fd, reinterpret_cast<const char*>(data),
                          static_cast<size_t>(n) * 4))) {
    set_error("send failed: " + std::string(strerror(errno)));
    return -1;
  }
  return 0;
}

// Blocking receive. timeout_s < 0 means wait indefinitely (until a message
// arrives or the transport is closed). Returns a TptMsg* (free with
// tpt_msg_free) or NULL on timeout/close.
void* tpt_recv(void* handle, double timeout_s) {
  auto* t = static_cast<TptTransport*>(handle);
  std::unique_lock<std::mutex> lk(t->mu);
  auto ready = [t] { return !t->inbox.empty() || t->closed.load(); };
  if (timeout_s < 0) {
    t->cv.wait(lk, ready);
  } else {
    t->cv.wait_for(lk, std::chrono::duration<double>(timeout_s), ready);
  }
  if (t->inbox.empty()) return nullptr;
  TptMsg* m = t->inbox.front();
  t->inbox.pop_front();
  return m;
}

int tpt_msg_sender(void* msg) { return static_cast<TptMsg*>(msg)->sender; }
int tpt_msg_code(void* msg) { return static_cast<TptMsg*>(msg)->code; }
int64_t tpt_msg_size(void* msg) { return static_cast<TptMsg*>(msg)->nfloats; }
float* tpt_msg_data(void* msg) { return static_cast<TptMsg*>(msg)->data; }

void tpt_msg_free(void* msg) {
  auto* m = static_cast<TptMsg*>(msg);
  free(m->data);
  delete m;
}

void tpt_close(void* handle) {
  static_cast<TptTransport*>(handle)->shutdown_all();
}

void tpt_free(void* handle) {
  auto* t = static_cast<TptTransport*>(handle);
  tpt_close(t);
  delete t;
}

}  // extern "C"
